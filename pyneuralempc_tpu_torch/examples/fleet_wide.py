"""Wide fleet MPC: a 10-rotor over-actuated multirotor, 12 states and 10
controls, H=50, thousands of initial conditions solved as one batch.

The port's copy of the JAX package's ``tools/fleet_wide_tpu.py``: the
quadrotor example's rigid body (:func:`.quadrotor.rigid_body`) with ten
rotors at angles 2πi/10, alternating spin, each problem steering one
initial condition to hover under thrust limits (a declared
:class:`StageCost` with a terminal term, box bounds).  Its stage, (nx, nu) = (12, 10), is the only fleet with more than
8 controls: the streamed sweep takes it, a compile-time backward and
forward instance on the card.

Run: python -m pyneuralempc_tpu_torch.examples.fleet_wide [--cpu]
     [--batch N] [--H H] [--steps S]

A cold solve, then S warm re-plans, each from the plan's first state.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..api.controller import NMPC
from ..core.problem import Box, StageCost
from ..models.base import torch_dynamics
from ..ops.cuda.riccati_kernel import kernel_plan
from ..solve.interior_point import IPConfig
from .quadrotor import G, rigid_body

M = 0.8
JX, JY, JZ = 4.0e-3, 4.0e-3, 7.0e-3
ARM, KTAU = 0.22, 0.016
N_ROT = 10
F_HOVER = M * G / N_ROT


def deca_f():
    """10-rotor rigid body ``f(x, u)`` on (T, 12), (T, 10): rotors at
    angles 2πi/10 (roll arms sin, pitch arms cos), alternating spin."""
    ang = np.arange(N_ROT) * 2 * np.pi / N_ROT
    sx = torch.as_tensor(np.sin(ang).astype(np.float32))
    cy = torch.as_tensor(np.cos(ang).astype(np.float32))
    spin = torch.as_tensor(np.where(np.arange(N_ROT) % 2 == 0, 1.0,
                                    -1.0).astype(np.float32))

    def f(x, u):
        # (T, 10) x (10,) arm products, the arms on u's device
        tau = torch.stack([ARM * (u @ sx.to(u.device)),
                           -ARM * (u @ cy.to(u.device)),
                           KTAU * (u @ spin.to(u.device))], dim=1)
        return rigid_body(x, torch.sum(u, dim=1, keepdim=True), tau, M,
                          (JX, JY, JZ))

    return f


def wide_cost() -> StageCost:
    """Hover tracking around the per-rotor hover thrust, plus a terminal
    position/velocity term."""
    return StageCost(
        stage=lambda x, u: (torch.sum(x[:3] ** 2)
                            + 0.1 * torch.sum(x[3:6] ** 2)
                            + 0.5 * torch.sum(x[6:8] ** 2) + 0.1 * x[8] ** 2
                            + 0.02 * torch.sum(x[9:] ** 2)
                            + 0.05 * torch.sum((u - F_HOVER) ** 2)),
        terminal=lambda x: 5.0 * (torch.sum(x[:3] ** 2)
                                  + torch.sum(x[3:6] ** 2)))


def wide_box() -> Box:
    return Box.make(
        states_constraint=[[-5.0, 5.0]] * 3 + [[-8.0, 8.0]] * 3
        + [[-0.8, 0.8]] * 2 + [[-np.pi, np.pi]] + [[-8.0, 8.0]] * 3,
        control_constraint=[[0.0, 2.5]] * N_ROT)


def wide_x0s(rng: np.random.Generator, B: int) -> np.ndarray:
    """(B, 12) float32 initial conditions, the JAX tool's draw: displaced
    positions, velocities and roll/pitch."""
    x0 = np.zeros((B, 12), np.float32)
    x0[:, 0:3] = rng.uniform(-1.0, 1.0, (B, 3))
    x0[:, 3:6] = rng.uniform(-0.5, 0.5, (B, 3))
    x0[:, 6:8] = rng.uniform(-0.3, 0.3, (B, 2))
    return x0


def make_fleet_wide_mpc(device="cuda", H: int = 50, DT: float = 0.02,
                        max_iter: int = 80) -> NMPC:
    """The wide fleet's NMPC: the true ODE, RK4, exact Hessians, Riccati
    KKT."""
    return NMPC(torch_dynamics(deca_f(), x_dim=12, u_dim=N_ROT),
                wide_cost(), [wide_box()], H=H, DT=DT, integrator="rk4",
                config=IPConfig(max_iter=max_iter), device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--H", type=int, default=50)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    H, B = args.H, args.batch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    mpc = make_fleet_wide_mpc(device, H=H)
    print(f"device={device} B={B} H={H} nu={N_ROT}  kkt backend: "
          f"{mpc.kkt_backend}  kernel_plan: "
          f"{kernel_plan(H, 12, N_ROT, device)}", flush=True)

    x0s = torch.as_tensor(wide_x0s(np.random.default_rng(0), B),
                          device=device)
    t0 = time.perf_counter()
    carry, res = mpc.next_batch(x0s)
    sync()
    print(f"cold batched solve: {time.perf_counter() - t0:.1f}s  "
          f"converged {int(res.converged.sum())}/{B}  iters max "
          f"{int(res.iterations.max())} mean "
          f"{float(res.iterations.float().mean()):.2f}", flush=True)

    if args.steps:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            carry, res = mpc.next_batch(res.x[:, 0], carry=carry)
        sync()
        dt = (time.perf_counter() - t0) / args.steps
        print(f"warm fleet step: {dt * 1e3:.0f}ms -> {B / dt:,.0f} "
              f"solves/s  converged {int(res.converged.sum())}/{B}  iters "
              f"max {int(res.iterations.max())} mean "
              f"{float(res.iterations.float().mean()):.2f}", flush=True)


if __name__ == "__main__":
    main()
