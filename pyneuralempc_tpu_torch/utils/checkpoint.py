"""Checkpoint and resume of model params and warm-start state.

PyTorch counterpart of ``pyneuralempc_tpu/utils/checkpoint.py``, with the
same ``.npz`` layout: the leaves as ``leaf_0``, ``leaf_1``, … in the JAX
package's flattening order (:func:`.tree.flatten`) and a ``__treedef__``
string.  So a checkpoint either package writes loads into the other's
counterpart structure (a params tree, a :class:`WarmStart`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .tree import flatten


def _describe(tree) -> str:
    """A description of the structure, in the style of the JAX package's
    treedef string (informative only: a load takes the structure from
    ``like``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_describe(v) for v in tree)
        if hasattr(tree, "_fields"):
            return f"{type(tree).__name__}({inner})"
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (tensors, arrays or numbers in dicts, lists, tuples and
    NamedTuples) to ``path`` as one ``.npz``."""
    leaves, _ = flatten(tree)
    arrays = {f"leaf_{i}": _numpy(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        f"PyTreeDef({_describe(tree)})".encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def load_pytree(path: str, like: Any) -> Any:
    """Load into the structure of ``like`` (leaf count and shapes checked);
    each leaf a tensor on the device of ``like``'s leaf where that is a
    tensor, else on the CPU."""
    leaves_like, rebuild = flatten(like)
    with np.load(path) as data:
        n = len(leaves_like)
        stored = [k for k in data.files if k.startswith("leaf_")]
        if len(stored) != n:
            raise ValueError(
                f"checkpoint has {len(stored)} leaves, expected {n}")
        leaves = []
        for i, want in enumerate(leaves_like):
            got = data[f"leaf_{i}"]
            shape = tuple(getattr(want, "shape", np.shape(want)))
            if got.shape != shape:
                raise ValueError(
                    f"leaf shape mismatch: {got.shape} vs {shape}")
            device = (want.device if isinstance(want, torch.Tensor)
                      else "cpu")
            leaves.append(torch.as_tensor(got, device=device))
    return rebuild(leaves)
