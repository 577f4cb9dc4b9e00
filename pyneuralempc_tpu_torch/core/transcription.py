"""Transcription: MPCSpec -> flat NLP functions.

PyTorch counterpart of ``pyneuralempc_tpu/core/transcription.py``.  Produces
the interior-point form

    min_w  J(w)    s.t.  C(w) = 0,   lb <= w <= ub

with decision vector ``w = [vec(X) | vec(U) | s]``: states first, controls
second.  The equality rows of ``C`` are the H·x_dim multiple-shooting
defects.  This slice has no path constraints, so the slack segment ``s`` is
always empty; the layout keeps it so later slices add slacks without moving
anything.

``objective`` and ``constraints`` are pure functions of ``(w, rt)`` for ONE
problem; the solver batches them with ``torch.func.vmap``.  ``pack`` and
``unpack`` act on the trailing axis, so they serve single problems and
batches alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .problem import MPCSpec
from ..models.base import _call_user_fn
from ..ops.integrators import step_fn
from ..ops.rollout import defects as _defects


@dataclasses.dataclass(frozen=True)
class NLP:
    """Flat NLP callables for one MPCSpec."""

    spec: MPCSpec
    n: int                 # total decision variables (primal + slack)
    m: int                 # total equality constraints
    objective: Callable    # (w, rt) -> scalar
    constraints: Callable  # (w, rt) -> (m,)
    lower: Any             # (n,) bound tensors (float32, ±inf allowed)
    upper: Any
    pack: Callable         # (X, U, s) -> w
    unpack: Callable       # w -> (X, U, s)
    init_slacks: Callable = None   # (X, U, rt) -> (n_slack,) g values
    shift_slacks: Callable = None  # (s,) -> (n_slack,) receding shift

    def lagrangian(self, w, lam, rt):
        """L(w, λ) = J(w) + λᵀC(w)."""
        return self.objective(w, rt) + torch.dot(lam,
                                                 self.constraints(w, rt))


def transcribe(spec: MPCSpec, dtype=torch.float32,
               device="cuda") -> NLP:
    H, dims = spec.H, spec.dims
    nx, nu = dims.x, dims.u
    n_primal = spec.n_primal
    n = n_primal
    m = spec.n_defect

    phi = step_fn(spec.model, spec.integrator, spec.DT)
    lower, upper = spec.box.tile(H, dtype, device)

    def unpack(w):
        lead = w.shape[:-1]
        X = w[..., : H * nx].reshape(*lead, H, nx)
        U = w[..., H * nx: n_primal].reshape(*lead, H, nu)
        s = w[..., n_primal:]
        return X, U, s

    def pack(X, U, s=None):
        parts = [X.flatten(-2), U.flatten(-2)]
        if s is not None:
            parts.append(s)
        return torch.cat(parts, dim=-1)

    def objective(w, rt):
        X, U, _ = unpack(w)
        return _call_user_fn(spec.objective, X, U, rt["p"], rt["tvp"])

    def constraints(w, rt):
        X, U, _ = unpack(w)
        return _defects(phi, X, U, rt["x0"], rt["p"], rt["tvp"],
                        rt.get("params")).reshape(-1).to(dtype)

    def init_slacks(X, U, rt):
        return torch.zeros(X.shape[:-2] + (0,), dtype=dtype,
                           device=X.device)

    def shift_slacks(s):
        return s

    return NLP(spec=spec, n=n, m=m, objective=objective,
               constraints=constraints, lower=lower, upper=upper,
               pack=pack, unpack=unpack, init_slacks=init_slacks,
               shift_slacks=shift_slacks)
