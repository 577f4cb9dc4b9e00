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

Run as a script, it profiles the JAX package's manual case, the LV MLP
fleet (2x32 tanh, random weights from seed 0, RK4, feed cost 1.1·Σu, the
bench box, DT=0.1) at ``$PROF_BATCH`` members (default 1024) and horizon
``$PROF_H`` (default 20), on the card (``--cpu``: on the CPU), and prints
the table to stderr:

    python -m pyneuralempc_tpu_torch.utils.profiling [--cpu]
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


def main(argv=None) -> Dict:
    """The manual profiling CLI (the JAX package's ``main``): the medians
    of :func:`profile_solver` on the LV MLP fleet, printed to stderr and
    returned.  Without ``--cpu`` it needs a CUDA device and fails where
    there is none."""
    import argparse
    import os
    import sys

    import numpy as np

    from ..api.controller import NMPC
    from ..core.problem import Box, StageCost
    from ..models.mlp import MLPDynamics

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device (pass --cpu to profile "
                         "on the CPU)")
    B = int(os.environ.get("PROF_BATCH", 1024))
    H = int(os.environ.get("PROF_H", 20))
    surrogate = MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    params = surrogate.init_params(torch.Generator().manual_seed(0),
                                   device=device)
    cost = StageCost(stage=lambda x, u: 1.1 * torch.sum(u))
    box = Box.make(states_constraint=[[-1.0, 1.0], [-1.0, 0.35]],
                   control_constraint=[[0.0, 1.2]])
    mpc = NMPC(surrogate, cost, [box], H=H, DT=0.1, integrator="rk4",
               device=device)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(np.stack([rng.uniform(0.2, 0.8, B),
                                    rng.uniform(-0.9, -0.3, B)], axis=1),
                          dtype=torch.float32, device=device)
    prof = profile_solver(mpc, x0s, params=params)
    where = (f"{torch.cuda.get_device_name(0)}" if device == "cuda"
             else "CPU")
    print(f"profile_solver, B={B}, H={H}, on {where}:", file=sys.stderr)
    for k, v in prof.items():
        print(f"{k:28s} {v * 1e3:8.2f} ms", file=sys.stderr)
    return prof


if __name__ == "__main__":
    main()
