"""Objective structure detection: route plain callables to the O(H) backend.

PyTorch counterpart of ``pyneuralempc_tpu/core/structure.py``.  A
stage-separable objective (Hessian block-diagonal over stages) keeps the O(H)
Riccati sweep eligible; :func:`probe_stage_separable` makes that decision
for plain ``J(x, u, p, tvp)`` callables, so users never have to declare
:class:`~pyneuralempc_tpu_torch.core.problem.StageCost` to get it.

Probe: at a few random trajectories, take Hessian-vector products with
tangents confined to one stage's variables ``(x_{t+1}, u_t)`` and test that
the response outside that stage is zero (to f32 noise).  The probe draws its
points with numpy from the same seed as the JAX package, so both packages
test the same points.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .problem import Dims
from ..models.base import _call_user_fn


@dataclasses.dataclass(frozen=True)
class SeparableObjective:
    """A plain trajectory objective that the probe certified stage-separable.

    Wrapping keeps the user's callable intact while telling the Riccati
    backend it may compute the cost Hessian as per-stage restricted blocks
    (any terminal term is absorbed into the last stage's block).
    """

    fn: Callable

    def __call__(self, x, u, p=None, tvp=None):
        return _call_user_fn(self.fn, x, u, p, tvp)


def probe_stage_separable(objective: Callable, dims: Dims, H: int,
                          n_points: int = 3, n_stages: int = 2,
                          rel_tol: float = 1e-5, seed: int = 0) -> bool:
    """Empirically test whether ``J``'s Hessian is block-diagonal over
    stages ``(x_{t+1}, u_t)``.

    Runs a handful of Hessian-vector products on CPU tensors in float32,
    whatever device the solver uses: trajectories are tiny, and a fixed
    device and precision keep the verdict reproducible.  Any exception from
    the user callable on random data reports non-separable.
    """
    nx, nu = dims.x, dims.u
    n = H * (nx + nu)
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    p = f32(rng.standard_normal(dims.p)) if dims.p else None
    tvp = f32(rng.standard_normal((H, dims.tvp))) if dims.tvp else None

    def J_flat(w):
        X = w[: H * nx].reshape(H, nx)
        U = w[H * nx:].reshape(H, nu)
        return _call_user_fn(objective, X, U, p, tvp)

    grad_J = torch.func.grad(J_flat)

    # stage t owns X[t] (w[t*nx:(t+1)*nx]) and U[t]
    # (w[H*nx + t*nu : H*nx + (t+1)*nu])
    idx = np.arange(n)
    stage_of = np.where(idx < H * nx, idx // nx, (idx - H * nx) // nu)

    stages = rng.choice(H, size=min(n_stages, H), replace=False)
    try:
        for _ in range(n_points):
            w = f32(rng.standard_normal(n))
            for t in stages:
                in_stage = torch.as_tensor(stage_of == t)
                v = torch.where(in_stage, f32(rng.standard_normal(n)), 0.0)
                hv = torch.func.jvp(grad_J, (w,), (v,))[1]
                if not bool(torch.all(torch.isfinite(hv))):
                    return False
                scale = float(torch.max(torch.abs(hv)))
                cross = float(torch.max(torch.abs(
                    torch.where(in_stage, 0.0, hv))))
                if cross > rel_tol * max(scale, 1.0):
                    return False
    except Exception:
        return False
    return True
