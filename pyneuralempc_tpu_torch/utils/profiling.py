"""Solver phase profiling.

PyTorch counterpart of ``pyneuralempc_tpu/utils/profiling.py``.
:func:`profile_solver` times the phases of one interior-point iteration
each alone on the controller's device, over the same batch, with
:func:`.timing.time_fn` (which waits for the device): the residuals and
objective gradient, the KKT blocks (``prepare``: the stage blocks of the
Riccati backend, the Hessian and Jacobian of the dense one), the KKT solve
on those blocks (the sweep kernels on the card), the merit line-search fan,
and a whole warm re-plan.  It shows where a warm re-plan's milliseconds go
before one reaches for a kernel.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.func import grad, vjp

from .timing import time_fn


def profile_solver(mpc, x0s, params=None, iters: int = 10) -> Dict:
    """Phase medians, in seconds, of ``mpc``'s batched solve at ``x0s``
    (B, x_dim), the JAX package's phases with its direction split in two:
    ``"residuals+grad"``, ``"stage blocks"``, ``"KKT sweep"``,
    ``"direction(blocks+sweep)"``, ``"line-search fan"``, ``"full warm
    step"``."""
    from ..core.problem import runtime
    from ..solve.interior_point import _vm, make_dense_direction
    from ..solve.riccati import make_riccati_direction

    nlp, cfg = mpc.nlp, mpc._ipcfg
    dev = mpc.device
    x0s = torch.as_tensor(x0s, device=dev)
    B = x0s.shape[0]
    rt = runtime(x0s, params=params)
    rt["_per_member"] = ()
    rt["_s_obj"] = torch.ones(B, device=dev)
    w = mpc.cold_start(x0s, params=params, per_member=()).w
    lam = torch.zeros((B, nlp.m), dtype=w.dtype, device=dev)
    mu = 1e-2
    sl = torch.clamp(w - nlp.lower, min=1e-6)
    su = torch.clamp(nlp.upper - w, min=1e-6)
    Sigma = torch.clamp(mu / sl ** 2 + mu / su ** 2, 0.0, 1e6)
    Sigma = torch.where(torch.isfinite(Sigma), Sigma, 0.0)
    r_tilde = torch.zeros_like(w)

    def residuals1(w1, rt1):
        g = grad(nlp.objective)(w1, rt1)
        c, cvjp = vjp(lambda ww: nlp.constraints(ww, rt1), w1)
        return g, c, cvjp(torch.zeros_like(c))[0]

    def residuals():
        return _vm(residuals1, rt, w)

    c0 = residuals()[1]
    direction = (make_riccati_direction(nlp, cfg)
                 if mpc.kkt_backend == "riccati"
                 else make_dense_direction(nlp, cfg))
    blocks = direction.prepare(w, lam, rt)
    alphas = 0.5 ** torch.arange(8, dtype=w.dtype, device=dev)

    def merit_fan():
        def one(a):
            wa = w * (1 - a * 1e-3)
            return (_vm(lambda ww, rt1: nlp.objective(ww, rt1), rt, wa)
                    + _vm(lambda ww, rt1: nlp.constraints(ww, rt1), rt, wa)
                    .abs().sum(-1))
        return [one(a) for a in alphas]

    out = {"residuals+grad": time_fn(residuals, iters=iters)["p50"]}
    out["stage blocks"] = time_fn(direction.prepare, w, lam, rt,
                                  iters=iters)["p50"]
    out["KKT sweep"] = time_fn(direction.solve_blocks, blocks, Sigma,
                               r_tilde, c0, iters=iters)["p50"]
    out["direction(blocks+sweep)"] = time_fn(
        direction, w, lam, rt, Sigma, r_tilde, c0, iters=iters)["p50"]
    out["line-search fan"] = time_fn(merit_fan, iters=iters)["p50"]

    carry, _ = mpc.next_batch(x0s, params=params)
    carry, _ = mpc.next_batch(x0s, params=params, carry=carry)
    out["full warm step"] = time_fn(
        lambda: mpc.next_batch(x0s, params=params, carry=carry),
        iters=iters)["p50"]
    return out
