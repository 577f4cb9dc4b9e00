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

The sweep itself (:func:`riccati_sweep`) runs as CUDA kernels on the card
(the fused kernel for the stages it instantiates, the streamed backward and
forward pair for the others) and as the plain PyTorch version on the CPU
(:mod:`..ops.cuda.riccati_kernel`).

Everything here is batch-first: the JAX package solves one problem and is
``vmap``-ed, the port carries a leading batch axis B through every tensor.
Stage-equality and trajectory-border constraints (the general sweep) are
ROADMAP Queue 1 #9.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import jacfwd, vjp, vmap

from ..core.problem import StageCost
from ..core.structure import SeparableObjective
from ..core.transcription import NLP
from ..models.base import _call_user_fn
from ..ops.cuda.riccati_kernel import riccati_sweep
from ..ops.cuda.riccati_kernel import riccati_sweep_plain as riccati_sweep_ref
from ..ops.integrators import step_fn
from ..ops.rollout import shift_states

__all__ = ["riccati_sweep", "riccati_sweep_ref", "eligible",
           "make_riccati_direction"]

# Global regularisation ladder: a member whose sweep fails at δ_i is
# re-swept at δ_{i+1}, per problem.
_DELTAS = (0.0, 1e-6, 1e-4, 1e-2, 1.0, 1e2)


def eligible(nlp: NLP) -> bool:
    """Riccati eligibility: a stage-separable cost, declared
    (:class:`StageCost`) or probe-certified (:class:`SeparableObjective`).
    This slice's problems carry box bounds only."""
    spec = nlp.spec
    return spec is not None and isinstance(spec.objective,
                                           (StageCost, SeparableObjective))


def make_riccati_direction(nlp: NLP, cfg) -> Callable:
    """KKT backend factory for :func:`..interior_point.make_solver`.

    Returns ``direction(w, lam, rt, Sigma, r_tilde, c) -> (dw, dlam, ok,
    resolve)`` with the split protocol attributes ``direction.prepare``
    (the expensive per-stage autodiff, once per iteration) and
    ``direction.solve_blocks`` (an rhs-only re-solve).  All arguments are
    batch-first; ``rt`` holds the batched ``x0`` (B, nx) and the optional
    per-member ``_s_obj`` (B,) beside the shared ``p``/``tvp``/``params``.
    """
    if not eligible(nlp):
        raise ValueError(
            "Riccati KKT backend needs a stage-separable objective "
            "(StageCost / probe-certified); the dense backend is not "
            "ported yet (ROADMAP Queue 1 #10)")
    spec = nlp.spec
    H, nx, nu = spec.H, spec.dims.x, spec.dims.u
    ns = nx + nu
    phi = step_fn(spec.model, spec.integrator, spec.DT)
    stage_cost = spec.objective

    def phi1(x, u, p, tvp_t, params):
        """Single-stage step: (nx,), (nu,) -> (nx,)."""
        tvp_b = None if tvp_t is None else tvp_t[None, :]
        return phi(x[None, :], u[None, :], p, tvp_b, params)[0]

    def stage_blocks(w, lam, rt):
        """Per-stage A, B (dynamics Jacobians), G (defect curvature) and M
        (cost Hessian), each (B, H, ·, ·)."""
        Bn = w.shape[0]
        X, U, _ = nlp.unpack(w)
        xprev = shift_states(rt["x0"], X)
        lam_t = lam[:, : H * nx].reshape(Bn, H, nx)
        tvp, p, params = rt["tvp"], rt["p"], rt.get("params")

        def per_stage(x_t, u_t, lam_row, tvp_t):
            def f(xu):
                return phi1(xu[:nx], xu[nx:], p, tvp_t, params)

            # forward-over-reverse: one jacfwd pass of the vjp gives the
            # defect curvature G = ∇²(λᵀΦ) and, as the tangent of the
            # primal output, the Jacobian J = ∂Φ
            def grad_and_val(z):
                v, vjp_fn = vjp(f, z)
                return vjp_fn(lam_row)[0], v

            G, J = jacfwd(grad_and_val)(torch.cat([x_t, u_t]))
            return J[:, :nx], J[:, nx:], G

        flat = (xprev.reshape(-1, nx), U.reshape(-1, nu),
                lam_t.reshape(-1, nx))
        if tvp is None:
            A, Bm, G = vmap(lambda x, u, l: per_stage(x, u, l, None))(*flat)
        else:
            tvp_f = tvp.expand(Bn, H, tvp.shape[-1]).reshape(-1,
                                                             tvp.shape[-1])
            A, Bm, G = vmap(per_stage)(*flat, tvp_f)
        A = A.reshape(Bn, H, nx, nx)
        Bm = Bm.reshape(Bn, H, nx, nu)
        G = G.reshape(Bn, H, ns, ns)

        if isinstance(stage_cost, StageCost):
            def cost_block(x_n, u_t, tvp_t):
                def f(z):
                    return _call_user_fn(stage_cost.stage, z[:nx], z[nx:],
                                         p, tvp_t)
                return torch.func.hessian(f)(torch.cat([x_n, u_t]))

            flat_c = (X.reshape(-1, nx), U.reshape(-1, nu))
            if tvp is None:
                M = vmap(lambda x, u: cost_block(x, u, None))(*flat_c)
            else:
                M = vmap(cost_block)(*flat_c, tvp_f)
            M = M.reshape(Bn, H, ns, ns)
            if stage_cost.terminal is not None:
                def term(xH):
                    return (stage_cost.terminal(xH, p) if p is not None
                            else stage_cost.terminal(xH))
                term_h = vmap(torch.func.hessian(term))(X[:, -1])
                M = M.clone()
                M[:, -1, :nx, :nx] += term_h
        else:
            # Probe-certified SeparableObjective: the full J's Hessian is
            # block-diagonal over stages, so each diagonal block is the
            # Hessian of J restricted to that stage's variables (a terminal
            # term lands in the last block by itself).
            steps = torch.arange(H, device=w.device)

            def blocks_of(X1, U1):
                def restricted(t, z):
                    at_t = (steps == t)[:, None]

                    def f(zz):
                        X2 = torch.where(at_t, zz[:nx], X1)
                        U2 = torch.where(at_t, zz[nx:], U1)
                        return _call_user_fn(stage_cost, X2, U2, p, tvp)
                    return torch.func.hessian(f)(z)
                return vmap(restricted)(steps, torch.cat([X1, U1], -1))

            M = vmap(blocks_of)(X, U)
        # objective auto-scaling (interior_point.make_solver): the cost
        # curvature must match the scaled gradient in r_tilde
        s_obj = rt.get("_s_obj")
        if s_obj is not None:
            M = M * s_obj.reshape(-1, 1, 1, 1)
        return A, Bm, G, M

    def prepare(w, lam, rt):
        """The expensive part of a KKT solve: per-stage derivative blocks.
        Returned as contiguous tensors, the layout the kernels take, so the
        solver can carry them through its loop and reuse them for the
        polish phase."""
        A, Bm, G, M0 = stage_blocks(w, lam, rt)
        G = torch.nan_to_num(G, posinf=1e10, neginf=-1e10)
        M0 = torch.nan_to_num(M0, posinf=1e10, neginf=-1e10)
        return tuple(t.contiguous() for t in (A, Bm, G, M0))

    def fold_sigma(M0, Sig):
        """Σ (bound barrier curvature) onto the per-stage diagonal."""
        Bn = M0.shape[0]
        Sig_x = Sig[:, : H * nx].reshape(Bn, H, nx)
        Sig_u = Sig[:, H * nx: H * ns].reshape(Bn, H, nu)
        d = torch.clamp(torch.nan_to_num(torch.cat([Sig_x, Sig_u], -1),
                                         posinf=1e10), 0.0, 1e10)
        M = M0 + torch.diag_embed(d)
        return torch.nan_to_num(M, posinf=1e10, neginf=-1e10)

    def solve_blocks(blocks, Sigma, r_tilde2, c2_full, retry=True):
        """Solve the condensed KKT system from prepared blocks.

        ``retry=False`` does a single δ=0 sweep (the SOC and polish
        re-solves).  Otherwise the ``_DELTAS`` ladder runs per problem:
        the batch is re-swept at the next δ while any member has failed,
        and each member keeps its result from the level where it first
        succeeded (the last level's when it never does) — the batch-first
        form of the JAX package's vmapped ``while_loop``.  Σ is folded per
        call, so a fresh bound Σ (the polish phase) needs no
        re-preparation."""
        A, Bm, G, M0 = blocks
        Bn = A.shape[0]
        M = fold_sigma(M0, Sigma)
        c2 = c2_full[:, : H * nx].reshape(Bn, H, nx).contiguous()
        m_x = r_tilde2[:, : H * nx].reshape(Bn, H, nx).contiguous()
        m_u = r_tilde2[:, H * nx: H * ns].reshape(Bn, H, nu).contiguous()

        def sweep(delta):
            d = torch.full((Bn,), delta, dtype=c2.dtype, device=c2.device)
            dX, dU, dLam, okc = riccati_sweep(A, Bm, G, M, m_x, m_u, c2, d)
            s_all = torch.zeros((Bn, 0), dtype=dX.dtype, device=dX.device)
            dw = nlp.pack(dX, dU, s_all)
            dlam = dLam.reshape(Bn, -1)
            ok = (okc & torch.isfinite(dw).all(-1)
                  & torch.isfinite(dlam).all(-1))
            return dw, dlam, ok

        if not retry:
            return sweep(_DELTAS[0])
        dw, dlam, ok = sweep(_DELTAS[0])
        for delta in _DELTAS[1:]:
            if bool(ok.all()):
                break
            dw_i, dlam_i, ok_i = sweep(delta)
            redo = ~ok
            dw = torch.where(redo[:, None], dw_i, dw)
            dlam = torch.where(redo[:, None], dlam_i, dlam)
            ok = ok | ok_i
        return dw, dlam, ok

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
        return tuple(torch.zeros((Bn, H) + shape, dtype=nlp.lower.dtype,
                                 device=device)
                     for shape in ((nx, nx), (nx, nu), (ns, ns), (ns, ns)))

    direction.prepare = prepare
    direction.solve_blocks = solve_blocks
    direction.zero_blocks = zero_blocks
    return direction
