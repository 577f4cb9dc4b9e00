"""Structured KKT backend: block-tridiagonal Riccati recursion.

PyTorch counterpart of ``pyneuralempc_tpu/solve/riccati.py``, plain path.
The interior-point Newton system of a multiple-shooting problem is
block-tridiagonal; this backend solves it by a backward Riccati sweep in
O(H · stage³), with the per-stage derivative blocks from ``torch.func``.

Per stage t (x_{t+1} is the decision state, x_0 the fixed parameter):

  * M_t  = ∇²ℓ_t over (x_{t+1}, u_t) + diag(Σ) on those variables;
  * G_t  = ∇²_{(x_t, u_t)} λ_tᵀΦ_t     (defect curvature);
  * m_t  = r̃ sliced to (x_{t+1}, u_t);
  * A_t, B_t = ∂Φ_t/∂(x_t, u_t).

Three constraint regimes, all O(H):

* box bounds and stage inequality/interval rows (:class:`StageConstraint`):
  their barrier curvature, the slack rows' eliminated, folds into the stage
  Hessian blocks, and the plain sweep (:func:`riccati_sweep`) solves it;
* stage EQUALITY rows: equality-constrained stage QPs inside the general
  sweep's backward recursion (:func:`riccati_sweep_general`);
* trajectory-level :class:`PathConstraint` rows: a low-rank BORDER.  The
  general sweep factorises the banded part once for 1 + q right-hand sides
  (the base one and one per border row), then a dense q×q Schur system
  couples the border multipliers.  Border-row curvature is dense across
  stages and is dropped from the step model on purpose (a Gauss-Newton
  border): the KKT residuals still carry the rows exactly, so the converged
  point is the true stationary point, and the merit line search absorbs
  the inexact step model.

The sweeps run as CUDA kernels on the card (the fused kernel for the stages
it instantiates, the streamed backward and forward pairs for the others)
and as their plain PyTorch versions on the CPU
(:mod:`..ops.cuda.riccati_kernel`, :mod:`..ops.cuda.riccati_general`).

Everything here is batch-first: the JAX package solves one problem and is
``vmap``-ed, the port carries a leading batch axis B through every tensor.
"""

from __future__ import annotations

from typing import Callable

import torch
import numpy as np
from torch.func import jacfwd, jacrev, vjp, vmap

from ..core.problem import EQ_TYPE, PathConstraint, StageConstraint, StageCost
from ..core.structure import SeparableObjective
from ..core.transcription import NLP
from ..models.base import _call_user_fn
from ..ops.cuda.riccati_general import riccati_sweep_general
from ..ops.cuda.riccati_general import (
    riccati_sweep_general_plain as riccati_sweep_general_ref)
from ..ops.cuda.riccati_kernel import riccati_sweep
from ..ops.cuda.riccati_kernel import riccati_sweep_plain as riccati_sweep_ref
from ..ops.integrators import step_fn
from ..ops.rollout import shift_states
from ..utils import tracing

__all__ = ["riccati_sweep", "riccati_sweep_ref", "riccati_sweep_general",
           "riccati_sweep_general_ref", "eligible", "make_riccati_direction"]

# Global regularisation ladder: a member whose sweep fails at δ_i is
# re-swept at δ_{i+1}, per problem.
_DELTAS = (0.0, 1e-6, 1e-4, 1e-2, 1.0, 1e2)


def eligible(nlp: NLP) -> bool:
    """Riccati eligibility: a stage-separable cost, declared
    (:class:`StageCost`) or probe-certified (:class:`SeparableObjective`),
    at most nu stage equality rows a stage (beyond that the stage control
    is over-determined) and at most 64 trajectory-level border rows (past
    that the border stops being low-rank).  Stage inequality and interval
    rows of any number fold into the sweep."""
    spec = nlp.spec
    if spec is None or not isinstance(spec.objective,
                                      (StageCost, SeparableObjective)):
        return False
    eq_rows_per_stage = 0
    border_rows = 0
    for pc in spec.path_constraints:
        if isinstance(pc, StageConstraint):
            eq_rows_per_stage += int((pc.row_types() == EQ_TYPE).sum())
        elif isinstance(pc, PathConstraint):
            border_rows += pc.dim
        else:
            return False
    return eq_rows_per_stage <= spec.dims.u and border_rows <= 64


def make_riccati_direction(nlp: NLP, cfg, sweep_impl=None) -> Callable:
    """KKT backend factory for :func:`..interior_point.make_solver`.

    ``sweep_impl``: the plain sweep to call in place of
    :func:`riccati_sweep` (the same contract), e.g.
    :func:`..pscan.riccati_sweep_pscan` for the O(log H) parallel-in-time
    sweep or :func:`..parallel.horizon.horizon_sweep`'s.  Only the plain
    path (no stage EQ rows, no trajectory border) takes one.

    Returns ``direction(w, lam, rt, Sigma, r_tilde, c) -> (dw, dlam, ok,
    resolve)`` with the split protocol attributes ``direction.prepare``
    (the expensive per-stage autodiff, once per iteration) and
    ``direction.solve_blocks`` (an rhs-only re-solve).  All arguments are
    batch-first; ``rt`` holds the batched ``x0`` (B, nx) and the optional
    per-member ``_s_obj`` (B,) beside ``p``/``tvp``/``params``, shared or,
    where ``rt["_per_member"]`` names them, leading with B.
    """
    if not eligible(nlp):
        raise ValueError(
            "Riccati KKT backend needs a stage-separable objective "
            "(StageCost / probe-certified), stage EQ rows totalling <= nu "
            "per stage, and at most 64 trajectory-level border rows; "
            "anything else falls to the dense backend.")
    spec = nlp.spec
    H, nx, nu = spec.H, spec.dims.x, spec.dims.u
    ns = nx + nu
    n_primal = spec.n_primal
    phi = step_fn(spec.model, spec.integrator, spec.DT)
    stage_cost = spec.objective
    dev = nlp.lower.device
    # "objective" / "gauss_newton" drop the defect and stage-constraint
    # curvature (G and Cv zero); the Riccati path has no dense W for
    # cfg.gn_reg to floor
    exact = cfg.hessian == "exact"

    # ---- static constraint-layout metadata (numpy, build time) ----
    # Rows of C after the defects follow spec order; the slack segment of w
    # likewise (``pos`` keeps each constraint's place, so the recovered step
    # is assembled in that order whatever the mix of kinds).  Stage rows
    # are stage-major: rows [t·r, (t+1)·r) belong to stage t, and a stage
    # constraint's slacks are its non-EQ rows in row order.
    def _idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    stage_pcs, traj_pcs = [], []
    _row, _sl = 0, 0
    for pos, pc in enumerate(spec.path_constraints):
        types = pc.row_types()
        eq_idx = np.nonzero(types == EQ_TYPE)[0]
        in_idx = np.nonzero(types != EQ_TYPE)[0]
        if isinstance(pc, StageConstraint):
            stage_pcs.append(dict(pc=pc, pos=pos, r=pc.dim, row_off=_row,
                                  slack_off=_sl, n_eq=len(eq_idx),
                                  n_in=len(in_idx), eq_idx=_idx(eq_idx),
                                  in_idx=_idx(in_idx)))
            _row += H * pc.dim
            _sl += H * len(in_idx)
        else:
            traj_pcs.append(dict(pc=pc, pos=pos, q=pc.dim, row_off=_row,
                                 slack_off=_sl, n_sl=len(in_idx),
                                 in_idx=_idx(in_idx),
                                 eq_mask=torch.as_tensor(types == EQ_TYPE,
                                                         device=dev)))
            _row += pc.dim
            _sl += len(in_idx)
    r_eq_total = sum(s["n_eq"] for s in stage_pcs)
    q_total = sum(t["q"] for t in traj_pcs)
    fast = (r_eq_total == 0 and q_total == 0)
    if not fast and sweep_impl is not None:
        raise ValueError(
            "custom sweep implementations (horizon sharding / pscan) "
            "support only the plain Riccati path; stage EQ rows and "
            "trajectory-level border constraints use the general sweep")
    the_sweep = riccati_sweep if sweep_impl is None else sweep_impl

    def phi1(x, u, p, tvp_t, params):
        """Single-stage step: (nx,), (nu,) -> (nx,)."""
        tvp_b = None if tvp_t is None else tvp_t[None, :]
        return phi(x[None, :], u[None, :], p, tvp_b, params)[0]

    def stage_blocks(w, lam, rt):
        """Per-stage A, B (dynamics Jacobians), G (defect curvature), M
        (cost Hessian plus stage-constraint curvature), each (B, H, ·, ·);
        the stage constraints' Jacobians (B, H, r, ns) and the border rows'
        (B, q, n_primal)."""
        Bn = w.shape[0]
        X, U, _ = nlp.unpack(w)
        xprev = shift_states(rt["x0"], X)
        lam_t = lam[:, : H * nx].reshape(Bn, H, nx)
        tvp, p, params = rt["tvp"], rt["p"], rt.get("params")
        # the inputs each member has its own of (p (B, np), tvp (B, H,
        # ntvp), params leading with B); shared ones are closed over
        own = {k: rt[k] for k in rt.get("_per_member", ())}

        def over_members(fn, *args):
            """vmap ``fn(*args_i, p, tvp, params)`` over the members, each
            with its own inputs where it has them."""
            if not own:
                return vmap(lambda *a: fn(*a, p, tvp, params))(*args)
            return vmap(lambda m, *a: fn(*a, m.get("p", p),
                                         m.get("tvp", tvp),
                                         m.get("params", params)))(own, *args)

        def over_stages(fn, *per_stage):
            """vmap ``fn(*per_stage_rows, tvp_t, p, params)`` over the B·H
            stages: one vmap of the flattened stages when every input is
            shared, else a vmap over the members of one over their H
            stages."""
            if not own:
                flat = [a.reshape((Bn * H,) + a.shape[2:])
                        for a in per_stage]
                if tvp is None:
                    return vmap(lambda *a: fn(*a, None, p, params))(*flat)
                tvp_f = tvp.expand(Bn, H, tvp.shape[-1]).reshape(
                    -1, tvp.shape[-1])
                return vmap(lambda *a: fn(*a, p, params))(*flat, tvp_f)

            def member(*a):
                *rows, p_i, tvp_i, params_i = a
                if tvp_i is None:
                    return vmap(lambda *r: fn(*r, None, p_i, params_i))(
                        *rows)
                return vmap(lambda *r: fn(*r, p_i, params_i))(
                    *rows, tvp_i.expand(H, tvp_i.shape[-1]))
            return over_members(member, *per_stage)

        def per_stage(x_t, u_t, lam_row, tvp_t, p, params):
            def f(xu):
                return phi1(xu[:nx], xu[nx:], p, tvp_t, params)

            xu = torch.cat([x_t, u_t])
            if not exact:
                # objective-only / Gauss-Newton curvature: no defect
                # curvature, so no reverse pass
                J = jacfwd(f)(xu)
                return J[:, :nx], J[:, nx:], J.new_zeros((ns, ns))

            # forward-over-reverse: one jacfwd pass of the vjp gives the
            # defect curvature G = ∇²(λᵀΦ) and, as the tangent of the
            # primal output, the Jacobian J = ∂Φ
            def grad_and_val(z):
                v, vjp_fn = vjp(f, z)
                return vjp_fn(lam_row)[0], v

            G, J = jacfwd(grad_and_val)(xu)
            return J[:, :nx], J[:, nx:], G

        with tracing.span("kkt.dynamics"):
            A, Bm, G = over_stages(per_stage, xprev, U, lam_t)
        A = A.reshape(Bn, H, nx, nx)
        Bm = Bm.reshape(Bn, H, nx, nu)
        G = G.reshape(Bn, H, ns, ns)

        # the stage and terminal costs' Hessians, times the objective's
        # scale
        with tracing.span("kkt.cost"):
            if isinstance(stage_cost, StageCost):
                def cost_block(x_n, u_t, tvp_t, p, params):
                    def f(z):
                        return _call_user_fn(stage_cost.stage, z[:nx], z[nx:],
                                             p, tvp_t)
                    return torch.func.hessian(f)(torch.cat([x_n, u_t]))

                M = over_stages(cost_block, X, U).reshape(Bn, H, ns, ns)
                if stage_cost.terminal is not None:
                    def term_hessian(xH, p, tvp, params):
                        def term(x):
                            return (stage_cost.terminal(x, p) if p is not None
                                    else stage_cost.terminal(x))
                        return torch.func.hessian(term)(xH)
                    term_h = over_members(term_hessian, X[:, -1])
                    M = M.clone()
                    M[:, -1, :nx, :nx] += term_h
            else:
                # Probe-certified SeparableObjective: the full J's Hessian is
                # block-diagonal over stages, so each diagonal block is the
                # Hessian of J restricted to that stage's variables (a terminal
                # term lands in the last block by itself).
                steps = torch.arange(H, device=w.device)

                def blocks_of(X1, U1, p, tvp, params):
                    def restricted(t, z):
                        at_t = (steps == t)[:, None]

                        def f(zz):
                            X2 = torch.where(at_t, zz[:nx], X1)
                            U2 = torch.where(at_t, zz[nx:], U1)
                            return _call_user_fn(stage_cost, X2, U2, p, tvp)
                        return torch.func.hessian(f)(z)
                    return vmap(restricted)(steps, torch.cat([X1, U1], -1))

                M = over_members(blocks_of, X, U)
            # objective auto-scaling (interior_point.make_solver): the cost
            # curvature must match the scaled gradient in r_tilde
            s_obj = rt.get("_s_obj")
            if s_obj is not None:
                M = M * s_obj.reshape(-1, 1, 1, 1)

        # Stage-constraint blocks: the Jacobian J_g = ∂g/∂(x_{t+1}, u_t)
        # and (exact mode) the curvature ν_tᵀ∇²g_t by the same
        # jacfwd-over-vjp.  The
        # curvature joins M AFTER the s_obj scaling: it is Lagrangian
        # curvature, not objective.  ν_t covers all of the stage's rows.
        Jgs = []
        for s in stage_pcs:
            pc, r = s["pc"], s["r"]
            nu_rows = lam[:, H * nx + s["row_off"]:
                          H * nx + s["row_off"] + H * r].reshape(Bn, H, r)

            def pc_one(x_n, u_t, nu_t, tvp_t, p, params, _pc=pc):
                def gfun(z):
                    return torch.atleast_1d(_call_user_fn(
                        _pc.stage, z[:nx], z[nx:], p, tvp_t))

                def grad_and_val(zz):
                    v, vjp_fn = vjp(gfun, zz)
                    return vjp_fn(nu_t)[0], v
                z = torch.cat([x_n, u_t])
                if not exact:
                    Jg = jacfwd(gfun)(z)
                    return Jg.to(z.dtype), z.new_zeros((ns, ns))
                Cv, Jg = jacfwd(grad_and_val)(z)
                # jacfwd of a row linear in z comes back as float64
                return Jg.to(z.dtype), Cv.to(z.dtype)

            Jg, Cv = over_stages(pc_one, X, U, nu_rows)
            M = M + Cv.reshape(Bn, H, ns, ns)
            Jgs.append(Jg.reshape(Bn, H, r, ns))

        # Trajectory-level border Jacobians (dense q × n_primal; q is small
        # by eligibility).  Their curvature is not added to the stage
        # blocks: the Gauss-Newton border (module docstring).
        Jqs = []
        for tp in traj_pcs:
            def jac_q(z, p, tvp, params, _pc=tp["pc"]):
                def gfun_q(zz):
                    Xz = zz[: H * nx].reshape(H, nx)
                    Uz = zz[H * nx:].reshape(H, nu)
                    return torch.atleast_1d(_call_user_fn(
                        _pc.fn, Xz, Uz, p, tvp)).reshape(-1)
                return jacrev(gfun_q)(z)
            Jqs.append(over_members(jac_q, w[:, :n_primal]).to(w.dtype))
        return A, Bm, G, M, Jgs, Jqs

    def prepare(w, lam, rt):
        """The expensive part of a KKT solve: per-stage derivative blocks
        and the border Jacobians, ``(A, B, G, M0, Jgs, Jqs)`` with Jgs and
        Jqs tuples.  Returned as contiguous tensors, the layout the kernels
        take, so the solver can carry them through its loop and reuse them
        for the polish phase."""
        A, Bm, G, M0, Jgs, Jqs = stage_blocks(w, lam, rt)
        G = torch.nan_to_num(G, posinf=1e10, neginf=-1e10)
        M0 = torch.nan_to_num(M0, posinf=1e10, neginf=-1e10)
        return (tuple(t.contiguous() for t in (A, Bm, G, M0))
                + (tuple(Jgs), tuple(Jqs)))

    def clip_sigma(S, lo=0.0):
        return torch.clamp(torch.nan_to_num(S, posinf=1e10), lo, 1e10)

    def fold_sigma(M0, Jgs, Sig):
        """Σ (bounds) and the stage constraints' slack elimination into the
        per-stage Hessian blocks.  With slack rows g_t(x_{t+1}, u_t) − s_t =
        −c_g and slack stationarity Σ_s Δs − Δν = −r̃_s, eliminating
        (Δs, Δν) condenses into the stage blocks:
            M_t += J_gᵀ Σ_s J_g      (non-EQ rows of J_g only)
            m_t += J_gᵀ (Σ_s ∘ c_g + r̃_s)
        and the eliminated steps come back after the sweep as
            Δs = J_g Δ(x,u) + c_g,   Δν = Σ_s ∘ Δs + r̃_s.
        δ applies to the (x,u) block only: Σ_s > 0 keeps the slack
        elimination well-posed at δ=0."""
        Bn = M0.shape[0]
        Sig_x = Sig[:, : H * nx].reshape(Bn, H, nx)
        Sig_u = Sig[:, H * nx: H * ns].reshape(Bn, H, nu)
        M = M0 + torch.diag_embed(clip_sigma(torch.cat([Sig_x, Sig_u], -1)))
        Sig_ss = []
        for s, Jg in zip(stage_pcs, Jgs):
            n_in = s["n_in"]
            if n_in == 0:
                Sig_ss.append(None)
                continue
            Jg_in = Jg[:, :, s["in_idx"], :]
            o = n_primal + s["slack_off"]
            Sig_s = clip_sigma(Sig[:, o: o + H * n_in].reshape(Bn, H, n_in))
            M = M + torch.einsum("bhrn,bhr,bhrm->bhnm", Jg_in, Sig_s, Jg_in)
            Sig_ss.append(Sig_s)
        return torch.nan_to_num(M, posinf=1e10, neginf=-1e10), Sig_ss

    def _stage_rhs(Jgs, Sig_ss, r_tilde2, c2_full):
        """Base right-hand side: r̃ sliced to (x, u) plus the condensed
        stage-slack terms; also the per-constraint (cg_in, rs) for the step
        recovery and the EQ-row residuals."""
        Bn = c2_full.shape[0]
        c2 = c2_full[:, : H * nx].reshape(Bn, H, nx)
        m_x = r_tilde2[:, : H * nx].reshape(Bn, H, nx)
        m_u = r_tilde2[:, H * nx: H * ns].reshape(Bn, H, nu)
        cg_ins, rss, cg_eqs = [], [], []
        for s, Jg, Sig_s in zip(stage_pcs, Jgs, Sig_ss):
            o = H * nx + s["row_off"]
            rows = c2_full[:, o: o + H * s["r"]].reshape(Bn, H, s["r"])
            cg_eqs.append(rows[..., s["eq_idx"]] if s["n_eq"] else None)
            n_in = s["n_in"]
            if n_in == 0:
                cg_ins.append(None)
                rss.append(None)
                continue
            cg_in = rows[..., s["in_idx"]]
            o = n_primal + s["slack_off"]
            rs = r_tilde2[:, o: o + H * n_in].reshape(Bn, H, n_in)
            d = torch.einsum("bhrn,bhr->bhn", Jg[:, :, s["in_idx"], :],
                             Sig_s * cg_in + rs)
            m_x = m_x + d[..., :nx]
            m_u = m_u + d[..., nx:]
            cg_ins.append(cg_in)
            rss.append(rs)
        return c2, m_x, m_u, cg_ins, rss, cg_eqs

    def _recover(dX, dU, dLam_def, dNu_eq, Jgs, Sig_ss, cg_ins, rss,
                 traj_parts):
        """Assemble (dw, dlam) in the transcription's layout: recover the
        eliminated stage slacks and multipliers, scatter the EQ-row
        multipliers into their rows, add the border slacks and multipliers,
        each constraint's parts at its place in spec order.  dX, dU,
        dLam_def (B, H, ·), dNu_eq (B, H, r_eq)."""
        Bn = dX.shape[0]
        dxu = torch.cat([dX, dU], dim=-1)
        slack_by, lam_by = {}, {}
        eq_col = 0
        for s, Jg, Sig_s, cg_in, rs in zip(stage_pcs, Jgs, Sig_ss, cg_ins,
                                           rss):
            lam_rows = dX.new_zeros((Bn, H, s["r"]))
            if s["n_in"]:
                ds = torch.einsum("bhrn,bhn->bhr", Jg[:, :, s["in_idx"], :],
                                  dxu) + cg_in
                slack_by[s["pos"]] = ds.reshape(Bn, -1)
                lam_rows[..., s["in_idx"]] = Sig_s * ds + rs
            if s["n_eq"]:
                lam_rows[..., s["eq_idx"]] = dNu_eq[..., eq_col:
                                                    eq_col + s["n_eq"]]
                eq_col += s["n_eq"]
            lam_by[s["pos"]] = lam_rows.reshape(Bn, -1)
        for tp, (ds_q, dnu_q) in zip(traj_pcs, traj_parts):
            if tp["n_sl"]:
                slack_by[tp["pos"]] = ds_q
            lam_by[tp["pos"]] = dnu_q
        slack_parts = [slack_by[k] for k in sorted(slack_by)]
        lam_parts = [dLam_def.reshape(Bn, -1)] + [lam_by[k]
                                                   for k in sorted(lam_by)]
        s_all = (torch.cat(slack_parts, dim=-1) if slack_parts
                 else dX.new_zeros((Bn, 0)))
        dw = nlp.pack(dX, dU, s_all)
        dlam = torch.cat(lam_parts, dim=-1)
        return dw, dlam, (torch.isfinite(dw).all(-1)
                          & torch.isfinite(dlam).all(-1))

    def ladder(sweep, retry):
        """The ``_DELTAS`` ladder, per problem: the batch is re-swept at the
        next δ while any member has failed, and each member keeps its result
        from the level where it first succeeded (the last level's when it
        never does) — the batch-first form of the JAX package's vmapped
        ``while_loop``.  ``retry=False`` does a single δ=0 sweep (the SOC
        and polish re-solves)."""
        with tracing.span("kkt.sweep"):
            dw, dlam, ok = sweep(_DELTAS[0])
        if not retry:
            return dw, dlam, ok
        for delta in _DELTAS[1:]:
            if tracing.read_bool("sync.ladder", ok.all()):
                break
            with tracing.span("kkt.sweep"):
                dw_i, dlam_i, ok_i = sweep(delta)
            redo = ~ok
            dw = torch.where(redo[:, None], dw_i, dw)
            dlam = torch.where(redo[:, None], dlam_i, dlam)
            ok = ok | ok_i
        return dw, dlam, ok

    def per_problem(value, like):
        return torch.full((like.shape[0],), value, dtype=like.dtype,
                          device=like.device)

    # ---- fast path: no EQ rows, no border: the plain sweep ----
    def solve_blocks_fast(blocks, Sigma, r_tilde2, c2_full, retry=True):
        """Solve the condensed KKT system from prepared blocks.  Σ is folded
        per call, so a fresh bound Σ (the polish phase) needs no
        re-preparation."""
        A, Bm, G, M0, Jgs, _ = blocks
        M, Sig_ss = fold_sigma(M0, Jgs, Sigma)
        c2, m_x, m_u, cg_ins, rss, _ = _stage_rhs(Jgs, Sig_ss, r_tilde2,
                                                  c2_full)
        c2, m_x, m_u = (t.contiguous() for t in (c2, m_x, m_u))
        no_eq = c2.new_zeros(c2.shape[:2] + (0,))

        def sweep(delta):
            dX, dU, dLam, okc = the_sweep(A, Bm, G, M, m_x, m_u, c2,
                                          per_problem(delta, c2))
            dw, dlam, okp = _recover(dX, dU, dLam, no_eq, Jgs, Sig_ss,
                                     cg_ins, rss, [])
            return dw, dlam, okc & okp

        return ladder(sweep, retry)

    # ---- general path: stage EQ rows and/or trajectory border ----
    def solve_blocks_general(blocks, Sigma, r_tilde2, c2_full, retry=True):
        A, Bm, G, M0, Jgs, Jqs = blocks
        Bn = A.shape[0]
        M, Sig_ss = fold_sigma(M0, Jgs, Sigma)
        c2, m_x, m_u, cg_ins, rss, cg_eqs = _stage_rhs(Jgs, Sig_ss, r_tilde2,
                                                       c2_full)

        # stage EQ data: E = JxB + Ju, F = JxA, h = −(c_g + Jx c)
        if r_eq_total:
            Jg_eq = torch.cat([Jg[:, :, s["eq_idx"], :] for s, Jg in
                               zip(stage_pcs, Jgs) if s["n_eq"]], dim=2)
            Jx_eq = Jg_eq[..., :nx].contiguous()         # (B, H, r, nx)
            E = Jx_eq @ Bm + Jg_eq[..., nx:]
            F = Jx_eq @ A
            cg_eq = torch.cat([ce for ce in cg_eqs if ce is not None], -1)
            h0 = -(cg_eq + (Jx_eq @ c2[..., None])[..., 0])
        else:
            Jx_eq = A.new_zeros((Bn, H, 0, nx))
            E = A.new_zeros((Bn, H, 0, nu))
            F = Jx_eq
            h0 = A.new_zeros((Bn, H, 0))

        # The rhs stack, stage-major (B, H, R, ·): the base right-hand side
        # then one per border row (its Jq row as the linear term, zero
        # defect and EQ residuals).
        m_x_all, m_u_all, c_all, h_all = (
            t[:, :, None] for t in (m_x, m_u, c2, h0))
        traj = []
        if q_total:
            Jq_all = torch.cat(Jqs, dim=1)               # (B, q, n_primal)
            D_rows, cq_hats = [], []
            for tp in traj_pcs:
                q = tp["q"]
                o = H * nx + tp["row_off"]
                cq = c2_full[:, o: o + q]
                Sq_full = A.new_ones((Bn, q))
                rq_full = A.new_zeros((Bn, q))
                if tp["n_sl"]:
                    o = n_primal + tp["slack_off"]
                    Sq_full[:, tp["in_idx"]] = clip_sigma(
                        Sigma[:, o: o + tp["n_sl"]], lo=1e-10)
                    rq_full[:, tp["in_idx"]] = r_tilde2[:, o: o + tp["n_sl"]]
                eq_m = tp["eq_mask"]
                D_rows.append(torch.where(eq_m, cfg.delta_c, 1.0 / Sq_full))
                cq_hats.append(cq + torch.where(eq_m, 0.0, rq_full / Sq_full))
                traj.append((tp, Sq_full, rq_full))
            D_all = torch.cat(D_rows, dim=-1)
            cq_hat_all = torch.cat(cq_hats, dim=-1)
            Jq_x = Jq_all[..., : H * nx].reshape(Bn, q_total, H, nx)
            Jq_u = Jq_all[..., H * nx:].reshape(Bn, q_total, H, nu)
            m_x_all = torch.cat([m_x_all, Jq_x.transpose(1, 2)], dim=2)
            m_u_all = torch.cat([m_u_all, Jq_u.transpose(1, 2)], dim=2)
            c_all = torch.cat([c_all, c2.new_zeros((Bn, H, q_total, nx))], 2)
            h_all = torch.cat([h_all, h0.new_zeros(
                (Bn, H, q_total, r_eq_total))], dim=2)
        m_x_all, m_u_all, c_all, h_all, E, F = (
            t.contiguous() for t in (m_x_all, m_u_all, c_all, h_all, E, F))
        dc = per_problem(cfg.delta_c, c2)

        def sweep(delta):
            dX, dU, dLam, dNu, okc = riccati_sweep_general(
                A, Bm, G, M, m_x_all, m_u_all, c_all, per_problem(delta, c2),
                dc, E, F, h_all, Jx_eq)
            dX_f, dU_f, dLam_f, dNu_f = (t[:, :, 0]
                                         for t in (dX, dU, dLam, dNu))
            traj_parts = []
            if q_total:
                # bordered Schur: (Jq Y − D) Δν_q = −(ĉ_q + Jq Δxu₀), rows
                # of Y the border right-hand sides' steps
                Ymat = torch.cat(
                    [dX[:, :, 1:].transpose(1, 2).reshape(Bn, q_total, -1),
                     dU[:, :, 1:].transpose(1, 2).reshape(Bn, q_total, -1)],
                    dim=-1)
                dxu0 = torch.cat([dX_f.reshape(Bn, -1),
                                  dU_f.reshape(Bn, -1)], dim=-1)
                S_b = Jq_all @ Ymat.mT - torch.diag_embed(D_all)
                rhs_b = -(cq_hat_all + (Jq_all @ dxu0[..., None])[..., 0])
                # solve_ex: a singular S_b reports info != 0 (JAX's solve
                # returns non-finite values) and the δ ladder re-sweeps
                dnu_b, info = torch.linalg.solve_ex(S_b, rhs_b[..., None])
                dnu_b = dnu_b[..., 0]
                okc = okc & (info == 0) & torch.isfinite(dnu_b).all(-1)
                dX_f, dU_f, dLam_f, dNu_f = (
                    t[:, :, 0] + torch.einsum("bhqn,bq->bhn", t[:, :, 1:],
                                              dnu_b)
                    for t in (dX, dU, dLam, dNu))
                col = 0
                for tp, Sq_full, rq_full in traj:
                    dnu_q = dnu_b[:, col: col + tp["q"]]
                    ds_q = ((dnu_q - rq_full) / Sq_full)[:, tp["in_idx"]]
                    traj_parts.append((ds_q, dnu_q))
                    col += tp["q"]
            dw, dlam, okp = _recover(dX_f, dU_f, dLam_f, dNu_f, Jgs, Sig_ss,
                                     cg_ins, rss, traj_parts)
            return dw, dlam, okc & okp

        return ladder(sweep, retry)

    solve_blocks = solve_blocks_fast if fast else solve_blocks_general

    def direction(w, lam, rt, Sigma, r_tilde, c_full):
        """Returns ``(dw, dlam, ok, resolve)``; ``resolve(r_tilde2, c2)``
        re-solves with the SAME stage blocks and a new right-hand side."""
        blocks = prepare(w, lam, rt)

        def resolve(r_tilde2, c2_full, retry=True, Sigma2=None):
            return solve_blocks(blocks, Sigma if Sigma2 is None else Sigma2,
                                r_tilde2, c2_full, retry=retry)

        dw, dlam, ok = solve_blocks(blocks, Sigma, r_tilde, c_full)
        return dw, dlam, ok, resolve

    def zero_blocks(Bn, device):
        """All-zero blocks with the structure ``prepare`` returns."""
        def z(*shape):
            return torch.zeros((Bn,) + shape, dtype=nlp.lower.dtype,
                               device=device)
        return (z(H, nx, nx), z(H, nx, nu), z(H, ns, ns), z(H, ns, ns),
                tuple(z(H, s["r"], ns) for s in stage_pcs),
                tuple(z(tp["q"], n_primal) for tp in traj_pcs))

    direction.prepare = prepare
    direction.solve_blocks = solve_blocks
    direction.zero_blocks = zero_blocks
    direction.general = not fast
    return direction
