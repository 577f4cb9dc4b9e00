"""Associative scan over a tuple of tensors.

PyTorch has no stable ``associative_scan``; this is ``jax.lax.
associative_scan``'s odd/even recursion: combine adjacent pairs, scan the
half, then fill in the even positions.  The composition tree is therefore
the JAX package's, and a scan differs from it only by each op's rounding.
O(log n) levels of batched ``fn`` calls.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def _sl(x: torch.Tensor, dim: int, start, stop, step=1) -> torch.Tensor:
    index = [slice(None)] * x.dim()
    index[dim] = slice(start, stop, step)
    return x[tuple(index)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a at the even positions of ``dim``, b at the odd ones; a is as long
    as b or one longer."""
    n = b.shape[dim]
    pairs = torch.stack([_sl(a, dim, 0, n), b], dim=dim + 1).flatten(
        dim, dim + 1)
    if a.shape[dim] == n:
        return pairs
    return torch.cat([pairs, _sl(a, dim, n, None)], dim=dim)


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor], dim: int,
                     reverse: bool = False) -> Tuple[torch.Tensor, ...]:
    """Inclusive scan of ``elems`` (a tuple of tensors with one length n
    along ``dim``) under the associative ``fn(a, b) -> c`` on tuples.

    ``fn`` is called on slices that keep every dim, so it must broadcast
    over the leading ones.  ``reverse=True`` scans from the end, and then,
    as in JAX, ``fn(a, b)`` gets ``a`` from the HIGHER index.
    """
    elems = tuple(elems)
    dim = dim % elems[0].dim()
    if reverse:
        elems = tuple(torch.flip(e, (dim,)) for e in elems)

    def scan(xs):
        n = xs[0].shape[dim]
        if n < 2:
            return xs
        reduced = fn(tuple(_sl(e, dim, 0, n - 1, 2) for e in xs),
                     tuple(_sl(e, dim, 1, None, 2) for e in xs))
        odd = scan(tuple(reduced))
        if n % 2 == 0:
            even = fn(tuple(_sl(e, dim, 0, -1) for e in odd),
                      tuple(_sl(e, dim, 2, None, 2) for e in xs))
        else:
            even = fn(odd, tuple(_sl(e, dim, 2, None, 2) for e in xs))
        even = tuple(torch.cat([_sl(e, dim, 0, 1), r], dim=dim)
                     for e, r in zip(xs, even))
        return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))

    out = scan(elems)
    if reverse:
        out = tuple(torch.flip(e, (dim,)) for e in out)
    return out
