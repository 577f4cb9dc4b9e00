"""EQ/border-constrained quadrotor fleet: the quadrotor of
:mod:`.quadrotor` (12 states, 4 rotor thrusts, H=50, RK4, exact Hessians)
steering to hover, with

* a stage EQUALITY row at every stage, zero net yaw torque:
  u0 − u1 + u2 − u3 = 0 (a rotor-trim constraint), which rides the
  equality-constrained stage QP of the general Riccati sweep;
* optionally (``border=True``) a trajectory-level row, the horizon's total
  thrust impulse capped, ΣU ≤ 50·4·F_HOVER·1.15: one row coupling every
  stage, solved as a rank-1 Schur border on a second right-hand side.

The port's copy of the JAX package's ``tools/fleet_eq_tpu.py``.  On the
card its KKT systems go through the general sweep's CUDA kernels
(``csrc/riccati_general.cu``) with R = 2 right-hand sides and r = 1
equality row a stage.

Run: python -m pyneuralempc_tpu_torch.examples.fleet_eq [--cpu]
     [--batch N] [--border] [--steps N]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..api.controller import NMPC
from ..core.problem import PathConstraint, StageConstraint
from ..models.base import torch_dynamics
from ..solve.interior_point import IPConfig
from .quadrotor import F_HOVER, quad_box, quad_cost, quad_f, quad_x0s

BUDGET = 50 * 4 * F_HOVER * 1.15   # horizon thrust impulse cap (N·stages)


def yaw_trim() -> StageConstraint:
    """Zero net yaw torque at every stage."""
    return StageConstraint(
        stage=lambda x, u: (u[0] - u[1] + u[2] - u[3])[None],
        dim=1, lb=(0.0,), ub=(0.0,))


def thrust_budget() -> PathConstraint:
    """ΣU ≤ BUDGET over the horizon: inactive at hover, active on hard
    starts."""
    return PathConstraint(fn=lambda X, U: torch.sum(U)[None], dim=1,
                          lb=(0.0,), ub=(BUDGET,))


def yaw_residual(u):
    """max |u0 − u1 + u2 − u3| over every stage of each plan: (B,)."""
    return (u[..., 0] - u[..., 1] + u[..., 2] - u[..., 3]).abs().amax(-1)


def make_fleet_eq_mpc(device="cuda", border: bool = True, H: int = 50,
                      DT: float = 0.02, max_iter: int = 80) -> NMPC:
    """The EQ (and, with ``border``, budget) constrained quadrotor NMPC."""
    truth = torch_dynamics(quad_f(), x_dim=12, u_dim=4)
    cons = [quad_box(), yaw_trim()]
    if border:
        cons.append(thrust_budget())
    return NMPC(truth, quad_cost(), cons, H=H, DT=DT, integrator="rk4",
                config=IPConfig(max_iter=max_iter), device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--border", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    B = args.batch
    mpc = make_fleet_eq_mpc(device, border=args.border)
    print(f"B={B} H=50 border={args.border} device={device} kkt backend: "
          f"{mpc.kkt_backend}")

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    x0s = torch.as_tensor(quad_x0s(np.random.default_rng(0), B),
                          device=device)
    t0 = time.perf_counter()
    carry, res = mpc.next_batch(x0s)
    sync()
    print(f"cold batched solve: {time.perf_counter() - t0:.1f}s  converged "
          f"{int(res.converged.sum())}/{B}  iters max "
          f"{int(res.iterations.max())}")
    print(f"max |u0-u1+u2-u3| across fleet: "
          f"{float(yaw_residual(res.u).max()):.2e}")
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        carry, res = mpc.next_batch(res.x[:, 0].contiguous(), carry=carry)
        sync()
        times.append(time.perf_counter() - t0)
    if times:
        dt = float(np.median(times))
        print(f"warm fleet step (median of {len(times)}): {dt * 1e3:.0f}ms "
              f"-> {B / dt:,.0f} solves/s  converged "
              f"{int(res.converged.sum())}/{B}  iters max "
              f"{int(res.iterations.max())} mean "
              f"{float(res.iterations.float().mean()):.2f}")
        print(f"max |u0-u1+u2-u3| across fleet (warm): "
              f"{float(yaw_residual(res.u).max()):.2e}")
    if args.border:
        total = res.u.sum(dim=(1, 2))
        print(f"thrust impulse: max {float(total.max()):.3f} (budget "
              f"{BUDGET:.3f}), binding on "
              f"{int((total > BUDGET - 1e-3).sum())}/{B} plans")


if __name__ == "__main__":
    main()
