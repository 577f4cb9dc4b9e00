"""Quadrotor fleet MPC: 12-state / 4-input dynamics, H=50, thousands of
initial conditions solved as one batch.

The port's copy of the JAX package's ``examples/quadrotor.py``: the true
ODE, or with ``--mlp`` a 2x256 tanh MLP surrogate fitted to it with
standardised inputs and targets and (sin, cos) attitude features
(:func:`..models.train.fit_normalized_surrogate`).  State: position p(3),
velocity v(3), attitude (roll, pitch, yaw), body rates ω(3).  Controls:
four rotor thrusts (N).  Each problem steers one initial condition to
hover at the origin under thrust limits, with a stage cost and a terminal
cost (a declared :class:`StageCost`) and box bounds.

Run: python -m pyneuralempc_tpu_torch.examples.quadrotor [--cpu]
     [--batch N] [--H H] [--mlp]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..api.controller import NMPC
from ..core.problem import Box, StageCost
from ..models.base import torch_dynamics
from ..models.train import fit_normalized_surrogate
from ..solve.interior_point import IPConfig

M, G = 0.5, 9.81
JX, JY, JZ = 2.3e-3, 2.3e-3, 4.0e-3
ARM, KTAU = 0.17, 0.016   # arm length, yaw-torque/thrust ratio
F_HOVER = M * G / 4.0


def rigid_body(x, T, tau, M, J):
    """Continuous-time rigid-body dynamics on (T, 12) states: position p(3),
    velocity v(3), attitude (roll, pitch, yaw; ZYX Euler), body rates ω(3),
    driven by the total thrust ``T`` (·, 1) along the body z-axis and the
    body torques ``tau`` (·, 3); mass ``M``, inertia ``J`` = (JX, JY,
    JZ)."""
    JX, JY, JZ = J
    v = x[:, 3:6]
    phi, th, psi = x[:, 6:7], x[:, 7:8], x[:, 8:9]
    om = x[:, 9:12]
    p_, q_, r_ = om[:, 0:1], om[:, 1:2], om[:, 2:3]

    sph, cph = torch.sin(phi), torch.cos(phi)
    sth, cth = torch.sin(th), torch.cos(th)
    sps, cps = torch.sin(psi), torch.cos(psi)

    # body z-axis in world frame (ZYX euler)
    zb = torch.cat([cph * sth * cps + sph * sps,
                    cph * sth * sps - sph * cps,
                    cph * cth], dim=1)
    acc = (T / M) * zb - torch.cat(
        [torch.zeros_like(T), torch.zeros_like(T),
         torch.full_like(T, G)], dim=1)

    # euler kinematics
    tth = sth / torch.clamp(cth, min=1e-3)
    dphi = p_ + sph * tth * q_ + cph * tth * r_
    dth = cph * q_ - sph * r_
    dpsi = (sph * q_ + cph * r_) / torch.clamp(cth, min=1e-3)

    tau_x, tau_y, tau_z = tau[:, 0:1], tau[:, 1:2], tau[:, 2:3]
    dom = torch.cat(
        [(tau_x - (JZ - JY) * q_ * r_) / JX,
         (tau_y - (JX - JZ) * p_ * r_) / JY,
         (tau_z - (JY - JX) * p_ * q_) / JZ], dim=1)

    return torch.cat([v, acc, torch.cat([dphi, dth, dpsi], dim=1), dom],
                     dim=1)


def quad_f():
    """Continuous-time rigid-body dynamics ``f(x, u)`` on (T, 12), (T, 4)."""

    def f(x, u):
        # torques from differential thrust (x config)
        tau = torch.cat([ARM * (u[:, 1:2] - u[:, 3:4]),
                         ARM * (u[:, 2:3] - u[:, 0:1]),
                         KTAU * (u[:, 0:1] - u[:, 1:2] + u[:, 2:3]
                                 - u[:, 3:4])], dim=1)
        return rigid_body(x, torch.sum(u, dim=1, keepdim=True), tau, M,
                          (JX, JY, JZ))

    return f


def quad_cost() -> StageCost:
    """Hover tracking: position, velocity, attitude, rates and thrust
    around hover, plus a terminal position/velocity term."""
    return StageCost(
        stage=lambda x, u: (torch.sum(x[:3] ** 2)
                            + 0.1 * torch.sum(x[3:6] ** 2)
                            + 0.5 * torch.sum(x[6:8] ** 2) + 0.1 * x[8] ** 2
                            + 0.02 * torch.sum(x[9:] ** 2)
                            + 0.05 * torch.sum((u - F_HOVER) ** 2)),
        terminal=lambda x: 5.0 * (torch.sum(x[:3] ** 2)
                                  + torch.sum(x[3:6] ** 2)))


def quad_box() -> Box:
    return Box.make(
        states_constraint=[[-5.0, 5.0]] * 3 + [[-8.0, 8.0]] * 3
        + [[-0.8, 0.8]] * 2 + [[-np.pi, np.pi]] + [[-8.0, 8.0]] * 3,
        control_constraint=[[0.0, 3.0]] * 4)


def quad_x0s(rng: np.random.Generator, B: int,
             rates: bool = False) -> np.ndarray:
    """(B, 12) float32 initial conditions: displaced positions, velocities
    and roll/pitch (the fleet benchmark's draw); ``rates=True`` also draws
    body rates, as the JAX package's example does."""
    x0s = np.zeros((B, 12), np.float32)
    x0s[:, 0:3] = rng.uniform(-1.0, 1.0, (B, 3))      # position offset
    x0s[:, 3:6] = rng.uniform(-0.5, 0.5, (B, 3))      # velocity
    x0s[:, 6:8] = rng.uniform(-0.3, 0.3, (B, 2))      # roll/pitch
    if rates:
        x0s[:, 9:12] = rng.uniform(-0.5, 0.5, (B, 3))
    return x0s


def quad_features(x):
    """Surrogate features: the attitude as (sin, cos) per Euler angle, the
    rest as it is (15 features)."""
    ang = x[:, 6:9]
    return torch.cat([x[:, :6], torch.sin(ang), torch.cos(ang), x[:, 9:12]],
                     dim=1)


def fit_quad_mlp(device="cuda", n: int = 262144, steps: int = 15000,
                 batch: int = 8192, seed: int = 0):
    """The ``--mlp`` surrogate: the JAX example's normalised fit (hidden
    [256, 256], x in ±1.5, thrusts in [0, 3]).  Returns (model, params,
    rel_mse)."""
    gen = torch.Generator().manual_seed(seed)
    return fit_normalized_surrogate(
        quad_f(), gen, x_dim=12, u_dim=4, hidden=[256, 256], n=n,
        x_range=(-1.5, 1.5), u_range=(0.0, 3.0), steps=steps, lr=1e-3,
        batch=batch, feature_map=quad_features, feature_dim=15,
        name="quad_mlp", device=device)


def make_quadrotor_mpc(device="cuda", H: int = 50, DT: float = 0.02,
                       max_iter: int = 80, model=None) -> NMPC:
    """The quadrotor NMPC: RK4, exact Hessians, Riccati KKT; the true ODE
    unless ``model`` (a surrogate) is given."""
    if model is None:
        model = torch_dynamics(quad_f(), x_dim=12, u_dim=4)
    return NMPC(model, quad_cost(), [quad_box()], H=H, DT=DT,
                integrator="rk4", config=IPConfig(max_iter=max_iter),
                device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--mlp", action="store_true")
    ap.add_argument("--H", type=int, default=50)
    ap.add_argument("--fit-n", type=int, default=262144,
                    help="--mlp: transitions sampled")
    ap.add_argument("--fit-steps", type=int, default=15000,
                    help="--mlp: Adam steps")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    H, DT, B = args.H, 0.02, args.batch
    model = params = None
    if args.mlp:
        model, params, rel_mse = fit_quad_mlp(
            device, n=args.fit_n, steps=args.fit_steps,
            batch=min(8192, args.fit_n))
        print(f"surrogate fitted: normalized mse={rel_mse:.2e}")
    mpc = make_quadrotor_mpc(device, H=H, DT=DT, model=model)
    print("kkt backend:", mpc.kkt_backend)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    x0s = torch.as_tensor(quad_x0s(np.random.default_rng(0), B, rates=True),
                          device=device)
    t0 = time.perf_counter()
    carry, res = mpc.next_batch(x0s, params=params)
    sync()
    print(f"cold batched solve ({B} scenarios): "
          f"{time.perf_counter() - t0:.1f}s  converged "
          f"{int(res.converged.sum())}/{B}")

    carry2, _ = mpc.next_batch(x0s * 0.98, params=params, carry=carry)
    sync()
    t0 = time.perf_counter()
    _, res3 = mpc.next_batch(x0s * 0.96, params=params, carry=carry2)
    sync()
    t_warm = time.perf_counter() - t0
    print(f"warm re-plan: {t_warm * 1e3:.0f}ms -> {B / t_warm:.0f} solves/s"
          f"  converged {int(res3.converged.sum())}/{B}")

    # sanity: plans steer towards hover; tilt-limited flight covers only so
    # much ground in H*DT seconds
    p_start = float(torch.linalg.norm(x0s[:, :3], dim=1).mean())
    p_end = float(torch.linalg.norm(res.x[:, -1, :3], dim=1).mean())
    print(f"mean |position|: start {p_start:.3f} -> end of plan {p_end:.3f}")
    factor = max(0.3, 1.0 - 0.3 * H * DT)
    if not p_end < factor * p_start:
        raise RuntimeError("plans do not approach hover")


if __name__ == "__main__":
    main()
