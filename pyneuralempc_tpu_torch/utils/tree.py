"""Nested containers of tensors (params trees, NamedTuple carries) as flat
lists of leaves, in the JAX package's flattening order: dict entries by
sorted key, list, tuple and NamedTuple entries in order, None holding no
leaf, anything else one leaf."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree) -> Tuple[List[Any], Callable]:
    """(leaves, rebuild): ``rebuild(leaves)`` gives ``tree``'s structure
    back around another list of the same length."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(leaves[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return [leaf for p in parts for leaf in p[0]], rebuild
