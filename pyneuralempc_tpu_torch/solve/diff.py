"""Differentiable MPC: gradients through the solve by the implicit function
theorem.

PyTorch counterpart of ``pyneuralempc_tpu/solve/diff.py``.  The solution
map θ → (w*, λ*) of the barrier-smoothed NLP satisfies G(w, λ; θ) = 0 with

    G = ( ∇_w J(w; θ) + A(w; θ)ᵀ λ − μ/(w−lb) + μ/(ub−w),   C(w; θ) ).

Its Jacobian with respect to (w, λ) is the symmetric condensed KKT matrix
[[W + Σ_μ, Aᵀ], [A, 0]] with the primal barrier curvature Σ_μ = μ/sl² +
μ/su², so the reverse-mode sensitivities take one more linear solve with
the same matrix:

    q = K⁻¹ [w̄; λ̄],        θ̄ = −(∂G/∂θ)ᵀ q            (one vjp of G).

:func:`make_differentiable_solver` wraps the batch-first solver in a
``torch.autograd.Function``: the forward pass is the ordinary solve (no
autograd graph); the backward pass is one KKT solve through the given
direction backend (the Riccati sweep, a CUDA kernel on the card) or, with
none, a dense LU, then one ``torch.func.vjp`` of G with respect to the
runtime's tensors (x0, p, tvp and the leaves of params, shared or per
member).  μ is each member's final barrier parameter, so the gradient is
that of the barrier-smoothed solution.

Gradients are zero for a member whose solve did not converge or whose KKT
solve failed (q is zeroed per member before the vjp, so a shared params
gradient sums the good members only), and warm starts (w0 and the duals)
get none: the converged solution does not depend on them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.func import grad, vjp

from ..core.transcription import NLP
from ..utils.tree import flatten
from .interior_point import (IPConfig, IPResult, _vm, kkt_matrix,
                             lu_solve_equilibrated, make_dense_direction,
                             make_solver)

_RT_KEYS = ("x0", "p", "tvp", "params")


def make_differentiable_solver(nlp: NLP, config: IPConfig = IPConfig(),
                               direction=None) -> Callable:
    """Like :func:`.interior_point.make_solver`, but the returned ``solve(rt,
    w0, ...)`` is differentiable with respect to the tensors of ``rt``:
    ``res.w``, ``res.lam`` and ``res.objective`` carry a ``grad_fn``."""
    # objective auto-scaling would make λ* belong to a scaled J and break
    # the stationarity identity: solve unscaled
    config = dataclasses.replace(config, auto_scale=False)
    base = make_solver(nlp, config, direction=direction)
    lb, ub = nlp.lower, nlp.upper
    has_lb, has_ub = torch.isfinite(lb), torch.isfinite(ub)
    n = nlp.n

    if direction is not None:
        kkt_fn = direction(nlp, config)

        def kkt_solve(w, lam, rt, Sigma, r_tilde, r_p):
            # the direction's resolve hook serves the solver's SOC only
            return kkt_fn(w, lam, rt, Sigma, r_tilde, r_p)[:3]
    else:
        blocks_fn = make_dense_direction(
            nlp, dataclasses.replace(config, hessian="exact")).prepare

        def kkt_solve(w, lam, rt, Sigma, r_tilde, r_p):
            # the exact Hessian, a zero (m, m) block and no δ retry
            W, A = blocks_fn(w, lam, rt)
            sol = lu_solve_equilibrated(kkt_matrix(W, Sigma, A, 0.0),
                                        torch.cat([-r_tilde, -r_p], -1))
            return sol[..., :n], sol[..., n:], torch.isfinite(sol).all(-1)

    def stationarity(w, lam, mu, rt):
        """G of every member at (w, λ, μ) under ``rt``."""
        sl = torch.where(has_lb, w - lb, 1.0)
        su = torch.where(has_ub, ub - w, 1.0)
        mu = mu[:, None]

        def one(w1, lam1, rt1):
            g = grad(nlp.objective)(w1, rt1)
            c, cvjp = vjp(lambda ww: nlp.constraints(ww, rt1), w1)
            return g + cvjp(lam1)[0], c

        r, c = _vm(one, rt, w, lam)
        return (r - torch.where(has_lb, mu / sl, 0.0)
                + torch.where(has_ub, mu / su, 0.0)), c

    class _Solve(torch.autograd.Function):
        @staticmethod
        def forward(ctx, box, w0, *leaves):
            rt = box["rt"]
            with torch.no_grad():
                res = base(rt, w0.detach())
            box["res"] = res
            ctx.box = box
            return res.w, res.lam

        @staticmethod
        def backward(ctx, w_bar, lam_bar):
            box = ctx.box
            rt, res, rebuild = box["rt"], box["res"], box["rebuild"]
            w, lam, mu = res.w, res.lam, res.mu
            w_bar = torch.zeros_like(w) if w_bar is None else w_bar
            lam_bar = (torch.zeros_like(lam) if lam_bar is None
                       else lam_bar)
            sl = torch.where(has_lb, w - lb, 1.0)
            su = torch.where(has_ub, ub - w, 1.0)
            Sigma = (torch.where(has_lb, mu[:, None] / sl ** 2, 0.0)
                     + torch.where(has_ub, mu[:, None] / su ** 2, 0.0))
            with torch.no_grad():
                q_w, q_lam, ok = kkt_solve(w, lam, rt, Sigma, -w_bar,
                                           -lam_bar)
            # −q on the good members, 0 elsewhere, before the vjp
            scale = torch.where(res.converged & ok, -1.0, 0.0).to(w.dtype)
            q_w = torch.nan_to_num(q_w) * scale[:, None]
            q_lam = torch.nan_to_num(q_lam) * scale[:, None]
            leaves = box["leaves"]
            need = [i for i, t in enumerate(leaves) if t.requires_grad]

            def G(*picked):
                full = list(leaves)
                for i, t in zip(need, picked):
                    full[i] = t
                return stationarity(w, lam, mu, rebuild(full))

            grads = [None] * len(leaves)
            if need:
                with torch.enable_grad():
                    _, vjp_fn = vjp(G, *[leaves[i].detach() for i in need])
                    for i, g in zip(need, vjp_fn((q_w, q_lam))):
                        grads[i] = g
            return (None, None, *grads)

    def solve(rt, w0, lam0=None, zl0=None, zu0=None, mu0=None) -> IPResult:
        # warm duals do not move the fixed point
        del lam0, zl0, zu0, mu0
        parts = [flatten(rt.get(k)) for k in _RT_KEYS]
        sizes = [len(p[0]) for p in parts]
        leaves = [t for p in parts for t in p[0]]

        def rebuild(flat):
            out, i = dict(rt), 0
            for k, (_, fn), n_k in zip(_RT_KEYS, parts, sizes):
                if rt.get(k) is not None:
                    out[k] = fn(flat[i:i + n_k])
                i += n_k
            return out

        box = {"rt": rt, "rebuild": rebuild, "leaves": leaves}
        w_star, lam_star = _Solve.apply(box, w0, *leaves)
        res = box["res"]
        # the result around the differentiable (w*, λ*): functions of
        # res.w, res.lam and res.objective get IFT gradients
        return res._replace(
            w=w_star, lam=lam_star,
            objective=_vm(nlp.objective, rebuild(leaves), w_star))

    return solve
