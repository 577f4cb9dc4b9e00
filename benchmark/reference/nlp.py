"""The judge of a plan: the KKT residuals of the MPC problem, worked out by
the plain reference at a primal-dual point that the program returned.

The problem is the one every configuration poses, in the interior-point
form that the program documents (``core/transcription.py``)::

    min_w  J(w)   s.t.  c_t = Φ(x_{t-1}, u_t) − x_t = 0  (t = 1..H),
                        lb ≤ w ≤ ub,

with w = [vec(X) | vec(U)], X[t] = x_{t+1}, x_0 given, and
J = Σ_t ℓ(X[t], U[t], tvp[t]) + φ(X[H−1], p).  The program returns w with
the defect multipliers λ and the bound multipliers z_l, z_u, and calls a
member converged when its KKT error, in its objective's scale s, is within
its tolerance.  The reference recomputes that error from its own Φ, ℓ and
φ, in float64, with autograd for ∇J and Aᵀλ:

* ``defect``: the largest defect |c| and bound violation;
* ``stationarity``: the largest |s∇J + Aᵀλ − z_l + z_u| over the dual
  scale s_d, or complementarity z·(distance to the bound) over s_c.

s is the program's documented gradient-based scaling (IPConfig
``auto_scale``: s = g_max / max(|∇J(w_start)|∞, g_max) at the point the
solve started from), and s_d, s_c its documented dual scales.  The
reference works out w_start itself: the previous plan shifted one stage,
or for a cold solve the zero-control rollout.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

S_MAX = 100.0      # the dual scales' floor (s_d, s_c)


@dataclasses.dataclass(frozen=True)
class Problem:
    """One configuration's reference problem, float64 on its device.

    ``phi(x_prev (T, nx), u (T, nu)) -> (T, nx)``; ``cost(X (N, H, nx),
    U (N, H, nu), tvp (N, H, k) | None, p (N, k) | None) -> (N,)``;
    ``lb``, ``ub`` (H·(nx+nu),) with ±inf where unbounded."""

    H: int
    nx: int
    nu: int
    phi: Callable
    cost: Callable
    lb: torch.Tensor
    ub: torch.Tensor
    scale_gmax: float = 100.0

    def unpack(self, w):
        N = w.shape[0]
        X = w[:, : self.H * self.nx].reshape(N, self.H, self.nx)
        U = w[:, self.H * self.nx:].reshape(N, self.H, self.nu)
        return X, U


def defects(pb: Problem, w, x0):
    X, U = pb.unpack(w)
    x_prev = torch.cat([x0[:, None], X[:, :-1]], dim=1)
    nxt = pb.phi(x_prev.reshape(-1, pb.nx), U.reshape(-1, pb.nu))
    return nxt.reshape(X.shape) - X


def shift(pb: Problem, w):
    """The receding-horizon shift: every stage one to the left, the last
    one repeated."""
    X, U = pb.unpack(w)
    X = torch.cat([X[:, 1:], X[:, -1:]], dim=1)
    U = torch.cat([U[:, 1:], U[:, -1:]], dim=1)
    return torch.cat([X.flatten(1), U.flatten(1)], dim=1)


def cold_start(pb: Problem, x0):
    """The zero-control rollout from x0, non-finite states read as 0."""
    U = x0.new_zeros((x0.shape[0], pb.H, pb.nu))
    xs, x = [], x0
    for t in range(pb.H):
        x = pb.phi(x, U[:, t])
        xs.append(x)
    X = torch.nan_to_num(torch.stack(xs, dim=1), nan=0.0, posinf=0.0,
                         neginf=0.0)
    return torch.cat([X.flatten(1), U.flatten(1)], dim=1)


def objective_scale(pb: Problem, w_start, tvp, p):
    w = w_start.detach().requires_grad_(True)
    X, U = pb.unpack(w)
    g, = torch.autograd.grad(pb.cost(X, U, tvp, p).sum(), w)
    return pb.scale_gmax / torch.clamp(g.abs().amax(-1), min=pb.scale_gmax)


def residuals(pb: Problem, x0, w, lam, zl, zu, w_prev: Optional[torch.Tensor],
              tvp=None, p=None) -> dict:
    """Per member (N,): ``defect`` and ``stationarity`` at the program's
    point (w, λ, z_l, z_u).  ``w_prev`` is the plan the solve was
    warm-started from (None: a cold solve).  Every tensor is converted to
    float64 on ``pb.lb``'s device."""
    f64 = dict(dtype=torch.float64, device=pb.lb.device)
    x0, w, lam, zl, zu = (t.to(**f64) for t in (x0, w, lam, zl, zu))
    tvp = None if tvp is None else tvp.to(**f64)
    p = None if p is None else p.to(**f64)
    if lam.shape[1] != pb.H * pb.nx:
        raise ValueError(f"{lam.shape[1]} multipliers, but the reference "
                         f"poses only the {pb.H * pb.nx} defect rows")
    w_start = (cold_start(pb, x0) if w_prev is None
               else shift(pb, w_prev.to(**f64)))
    s = objective_scale(pb, w_start, tvp, p)

    w = w.detach().requires_grad_(True)
    X, U = pb.unpack(w)
    c = defects(pb, w, x0).reshape(w.shape[0], -1)
    J = pb.cost(X, U, tvp, p)
    g, = torch.autograd.grad(J.sum(), w, retain_graph=True)
    ATlam, = torch.autograd.grad((c * lam).sum(), w)
    w, c = w.detach(), c.detach()

    has_lb, has_ub = torch.isfinite(pb.lb), torch.isfinite(pb.ub)
    n_bounds = max(int(has_lb.sum()) + int(has_ub.sum()), 1)
    sl = torch.where(has_lb, torch.clamp(w - pb.lb, min=1e-12), 1.0)
    su = torch.where(has_ub, torch.clamp(pb.ub - w, min=1e-12), 1.0)
    viol = torch.maximum(torch.where(has_lb, torch.relu(pb.lb - w), 0.0),
                         torch.where(has_ub, torch.relu(w - pb.ub), 0.0))
    r_d = s[:, None] * g + ATlam - zl + zu
    comp = torch.maximum(torch.where(has_lb, zl * sl, 0.0),
                         torch.where(has_ub, zu * su, 0.0))
    m = lam.shape[1]
    s_d = torch.clamp((lam.abs().sum(-1) + zl.sum(-1) + zu.sum(-1))
                      / (m + n_bounds), min=S_MAX) / S_MAX
    s_c = torch.clamp((zl.sum(-1) + zu.sum(-1)) / n_bounds,
                      min=S_MAX) / S_MAX
    stationarity = torch.maximum(r_d.abs().amax(-1) / s_d,
                                 comp.abs().amax(-1) / s_c)
    defect = torch.maximum(c.abs().amax(-1), viol.amax(-1))
    bad = ~(torch.isfinite(defect) & torch.isfinite(stationarity))
    inf = torch.full_like(defect, float("inf"))
    return {"defect": torch.where(bad, inf, defect),
            "stationarity": torch.where(bad, inf, stationarity)}
