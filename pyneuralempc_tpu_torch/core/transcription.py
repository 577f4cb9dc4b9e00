"""Transcription: MPCSpec -> flat NLP functions.

PyTorch counterpart of ``pyneuralempc_tpu/core/transcription.py``.  Produces
the interior-point form

    min_w  J(w)    s.t.  C(w) = 0,   lb <= w <= ub

with decision vector ``w = [vec(X) | vec(U) | s]``: states first, controls
second, then slack variables ``s`` for the non-equality rows of the path
constraints.  The equality rows of ``C`` are

  1. the H·x_dim multiple-shooting defects;
  2. for each path constraint, in spec order: EQ rows as ``g(w) - lb`` and
     the other rows as ``g(w) - s``, with ``s`` box-bounded by (lb, ub).

``objective`` and ``constraints`` are pure functions of ``(w, rt)`` for ONE
problem; the solver batches them with ``torch.func.vmap``.  ``pack`` and
``unpack`` act on the trailing axis, so they serve single problems and
batches alike.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .problem import EQ_TYPE, MPCSpec, StageConstraint
from .problem import expand_constraint as _expand
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

    phi = step_fn(spec.model, spec.integrator, spec.DT)

    # ---- static slack bookkeeping (numpy, build time) ----
    # per constraint: (traj_fn, non-EQ row indices, slack offset, lb on EQ
    # rows and 0 elsewhere, slack count, slacks per stage or None, and for
    # each row 1 + its slack's index, 0 on EQ rows)
    pcs = []
    slack_lb, slack_ub = [], []
    n_slack = 0
    n_pc_rows = 0
    for pc in spec.path_constraints:
        traj_fn, n_rows, types, lb, ub = _expand(pc, H)
        eq_mask = types == EQ_TYPE
        in_idx = np.nonzero(~eq_mask)[0]
        n_sl = len(in_idx)
        r_stage = (n_sl // H if isinstance(pc, StageConstraint)
                   and n_sl % H == 0 else None)
        pos = np.zeros(n_rows, np.int64)
        pos[in_idx] = np.arange(1, n_sl + 1)
        pcs.append((traj_fn, torch.as_tensor(in_idx, device=device), n_slack,
                    torch.as_tensor(np.where(eq_mask, lb, 0.0), dtype=dtype,
                                    device=device), n_sl, r_stage,
                    torch.as_tensor(pos, device=device)))
        slack_lb.append(lb[in_idx])
        slack_ub.append(ub[in_idx])
        n_slack += n_sl
        n_pc_rows += n_rows

    n = n_primal + n_slack
    m = spec.n_defect + n_pc_rows
    lower, upper = spec.box.tile(H, dtype, device)
    if n_slack:
        lower = torch.cat([lower, torch.as_tensor(
            np.concatenate(slack_lb), dtype=dtype, device=device)])
        upper = torch.cat([upper, torch.as_tensor(
            np.concatenate(slack_ub), dtype=dtype, device=device)])
    sl_lb, sl_ub = lower[n_primal:], upper[n_primal:]

    def unpack(w):
        lead = w.shape[:-1]
        X = w[..., : H * nx].reshape(*lead, H, nx)
        U = w[..., H * nx: n_primal].reshape(*lead, H, nu)
        s = w[..., n_primal:]
        return X, U, s

    def pack(X, U, s=None):
        parts = [X.flatten(-2), U.flatten(-2)]
        if n_slack:
            parts.append(X.new_zeros(X.shape[:-2] + (n_slack,)) if s is None
                         else s)
        return torch.cat(parts, dim=-1)

    def objective(w, rt):
        X, U, _ = unpack(w)
        return _call_user_fn(spec.objective, X, U, rt["p"], rt["tvp"])

    def constraints(w, rt):
        X, U, s = unpack(w)
        rows = [_defects(phi, X, U, rt["x0"], rt["p"], rt["tvp"],
                         rt.get("params")).reshape(-1)]
        for traj_fn, _, off, eq_lb, n_sl, _, pos in pcs:
            g = traj_fn(X, U, rt["p"], rt["tvp"]) - eq_lb
            if n_sl:
                # slacks gathered into the non-EQ row positions
                s_pad = torch.cat([s.new_zeros((1,)), s[off: off + n_sl]])
                g = g - s_pad[pos]
            rows.append(g)
        return torch.cat(rows).to(dtype)

    # Slacks start at the constraint value (Ipopt's rule; the solver's κ₁
    # push moves them inside later): a zero start would charge the solver
    # an artificial path residual g(w0) - 0.
    def init_slacks(X, U, rt):
        if not n_slack:
            return torch.zeros(X.shape[:-2] + (0,), dtype=dtype,
                               device=X.device)

        def one(X1, U1):
            return torch.cat([traj_fn(X1, U1, rt["p"], rt["tvp"])[in_idx]
                              for traj_fn, in_idx, *_ in pcs if len(in_idx)])
        s = (one(X, U) if X.dim() == 2 else torch.func.vmap(one)(X, U))
        return torch.clamp(torch.nan_to_num(s.to(dtype)), sl_lb, sl_ub)

    # Receding-horizon shift: a StageConstraint's slacks (stage-major) move
    # one stage left and the last stage repeats; a trajectory-level
    # constraint's slacks carry over as they are.
    def shift_slacks(s):
        if not n_slack:
            return s
        parts = []
        for _, _, off, _, n_sl, r_stage, _ in pcs:
            s_i = s[..., off: off + n_sl]
            if r_stage:
                s_t = s_i.reshape(s_i.shape[:-1] + (H, r_stage))
                s_i = torch.cat([s_t[..., 1:, :], s_t[..., -1:, :]],
                                dim=-2).flatten(-2)
            parts.append(s_i)
        return torch.cat(parts, dim=-1)

    return NLP(spec=spec, n=n, m=m, objective=objective,
               constraints=constraints, lower=lower, upper=upper,
               pack=pack, unpack=unpack, init_slacks=init_slacks,
               shift_slacks=shift_slacks)
