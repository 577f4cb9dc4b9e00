"""Secondary solver: augmented-Lagrangian method (ALM).

PyTorch counterpart of ``pyneuralempc_tpu/solve/alm.py``: a second,
Hessian-flexible algorithm beside the primal-dual interior point.  It
minimises the augmented Lagrangian

    AL(w; y, ρ) = J(w) + yᵀC(w) + (ρ/2)‖C(w)‖²     s.t. lb ≤ w ≤ ub

in an outer loop over (y, ρ).  Each inner subproblem is box-constrained
only, so it reuses the interior-point solver with one zero equality row and
the dense KKT backend (the barrier handles the bounds; Newton or
Gauss-Newton curvature per ``IPConfig.hessian``).  Outer updates: y ← y +
ρ·C(w); ρ ← ρ·factor when the infeasibility does not contract.

Batch-first: the outer loop runs on the host over the whole batch, with y,
ρ, the last infeasibility and the done and converged flags held per member.
Each outer iteration solves the members still live as one batch, and
members that are done keep their state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch
from torch.func import jacrev

from ..core.transcription import NLP
from ..utils.tree import flatten
from .interior_point import IPConfig, IPResult, _vm, make_solver


@dataclasses.dataclass(frozen=True)
class ALMConfig:
    """Outer-loop settings; ``ip`` configures the inner subproblem solver
    (``ip.hessian='gauss_newton'`` for a Hessian-free mode).  Fields and
    defaults are the JAX package's."""

    ip: IPConfig = IPConfig(max_iter=25, tol=1e-5)
    outer_iter: int = 12
    rho_init: float = 10.0
    rho_factor: float = 5.0
    rho_max: float = 1e6
    tol_feas: float = 1e-5         # ‖C(w)‖∞ target
    contraction: float = 0.5       # required per-outer infeasibility drop


class _ALMState(NamedTuple):
    """Per-member outer state; every field leads with the batch axis."""
    w: Any
    y: Any
    rho: Any
    theta_prev: Any
    it: Any
    done: Any
    converged: Any
    inner_kkt: Any
    zl: Any            # bound duals of the last inner solve (the inner
    zu: Any            # problem has the same box, so they are the NLP's)
    mu: Any            # inner barrier parameter at exit


def _take(rt, idx):
    """The runtime dict of members ``idx``: the per-member entries (x0 and
    the keys ``_per_member`` names) indexed, shared ones as they are."""
    out = dict(rt)
    for k in ("x0",) + tuple(rt.get("_per_member", ())):
        leaves, rebuild = flatten(rt.get(k))
        out[k] = rebuild([leaf[idx] for leaf in leaves])
    return out


def make_alm_solver(nlp: NLP, config: ALMConfig = ALMConfig()):
    """Build ``solve(rt, w0, lam0=None, ...) -> IPResult`` for a batch (the
    interface of :func:`.interior_point.make_solver`, so the controller
    treats both alike)."""
    cfg = config
    if cfg.ip.record:
        raise ValueError(
            "IPConfig(record=True) is not supported inside ALM inner "
            "solves (the outer loop cannot carry per-inner-solve "
            "traces); record on the primary interior-point solver instead.")
    m = nlp.m
    dtype = nlp.lower.dtype

    def al_objective(w, rt):
        c = nlp.constraints(w, rt)
        return (nlp.objective(w, rt) + torch.dot(rt["alm_y"], c)
                + 0.5 * rt["alm_rho"] * torch.dot(c, c))

    def no_rows(w, rt):
        return torch.zeros((1,), dtype=dtype, device=w.device)

    inner_nlp = NLP(spec=nlp.spec, n=nlp.n, m=1, objective=al_objective,
                    constraints=no_rows, lower=nlp.lower, upper=nlp.upper,
                    pack=nlp.pack, unpack=nlp.unpack)

    hessian_fn = None
    if cfg.ip.hessian == "gauss_newton":
        # Hessian-free mode: Gauss-Newton curvature of the original
        # equality residuals, ρ·AᵀA (the inner problem's own constraint set
        # is empty, so the generic rule would give zero curvature)
        eye_n = torch.eye(nlp.n, dtype=dtype, device=nlp.lower.device)

        def hessian_fn(w, lam, rt1):
            A = jacrev(lambda ww: nlp.constraints(ww, rt1))(w)
            return rt1["alm_rho"] * A.T @ A + cfg.ip.gn_reg * eye_n

    inner_solve = make_solver(inner_nlp, cfg.ip, hessian_fn=hessian_fn)

    def solve(rt, w0, lam0=None, zl0=None, zu0=None, mu0=None) -> IPResult:
        w0 = w0.to(dtype)
        Bn, dev = w0.shape[0], w0.device
        st = _ALMState(
            w=w0,
            y=(torch.zeros((Bn, m), dtype=dtype, device=dev) if lam0 is None
               else lam0.to(dtype)),
            rho=torch.full((Bn,), cfg.rho_init, dtype=dtype, device=dev),
            theta_prev=torch.full((Bn,), torch.inf, dtype=dtype, device=dev),
            it=torch.zeros((Bn,), dtype=torch.int32, device=dev),
            done=torch.zeros((Bn,), dtype=torch.bool, device=dev),
            converged=torch.zeros((Bn,), dtype=torch.bool, device=dev),
            inner_kkt=torch.full((Bn,), torch.inf, dtype=dtype, device=dev),
            zl=torch.zeros_like(w0), zu=torch.zeros_like(w0),
            mu=torch.full((Bn,), cfg.ip.tol, dtype=dtype, device=dev))
        for _ in range(cfg.outer_iter):
            live = torch.nonzero(~st.done & (st.it < cfg.outer_iter)
                                 ).flatten()
            if live.numel() == 0:
                break
            rt_in = _take(rt, live)
            rt_in["alm_y"] = st.y[live]
            rt_in["alm_rho"] = st.rho[live]
            rt_in["_per_member"] = tuple(rt.get("_per_member", ())) + (
                "alm_y", "alm_rho")
            res = inner_solve(rt_in, st.w[live])
            c = _vm(lambda ww, rt1: nlp.constraints(ww, rt1), rt_in, res.w)
            th = c.abs().amax(-1)
            rho = st.rho[live]
            y_new = torch.clamp(st.y[live] + rho[:, None] * c, -1e8, 1e8)
            contracted = th <= cfg.contraction * st.theta_prev[live]
            rho_new = torch.where(contracted, rho, torch.clamp(
                rho * cfg.rho_factor, max=cfg.rho_max))
            converged = (th <= cfg.tol_feas) & (res.kkt_error
                                                <= cfg.ip.tol * 10.0)
            new = dict(w=res.w, y=y_new, rho=rho_new, theta_prev=th,
                       it=st.it[live] + 1, done=converged,
                       converged=converged, inner_kkt=res.kkt_error,
                       zl=res.zl, zu=res.zu, mu=res.mu)
            fields = {}
            for k, v in st._asdict().items():
                v = v.clone()
                v[live] = new[k].to(v.dtype)
                fields[k] = v
            st = _ALMState(**fields)

        c = _vm(lambda ww, rt1: nlp.constraints(ww, rt1), rt, st.w)
        theta_inf = (c.abs().amax(-1) if m
                     else torch.zeros((Bn,), dtype=dtype, device=dev))
        # the last inner solve's bound duals and barrier parameter are the
        # NLP's (same box), so a warm carry resumes them
        return IPResult(w=st.w, lam=st.y, zl=st.zl, zu=st.zu, mu=st.mu,
                        converged=st.converged, iterations=st.it,
                        kkt_error=torch.maximum(st.inner_kkt, theta_inf),
                        objective=_vm(nlp.objective, rt, st.w),
                        theta=theta_inf, feasible=theta_inf <= cfg.tol_feas,
                        restorations=torch.zeros((Bn,), dtype=torch.int32,
                                                 device=dev))

    return solve
