"""Cartpole swing-up by economic NMPC (BASELINE config 3).

The port's copy of the JAX package's ``examples/cartpole.py``.  4 states
(cart position and velocity, pole angle and rate), 1 input (cart force),
H=50, nonlinear dynamics, a nonlinear state constraint (the pole tip's
horizontal clearance |pos + L·sin θ| ≤ TIP_MAX, a stage interval row that
folds into the Riccati sweep), box bounds and an economic cost (energy
shaping plus an effort price, no reference trajectory).

θ is measured from upright (θ = 0 up, θ = π hanging): the controller must
find the pumping manoeuvre by itself while keeping the tip inside the
clearance envelope.  One problem is re-planned every 2 plant steps in a
host loop over :meth:`NMPC.next`; on the card its KKT sweeps take the
streamed plain pair at (nx, nu) = (4, 1).

Run: python -m pyneuralempc_tpu_torch.examples.cartpole [--cpu] [--mlp]
     [--steps N] [--H H] [--max-iter N]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..api.controller import NMPC
from ..core.problem import Box, StageCost, stage_interval
from ..models.base import torch_dynamics
from ..models.train import fit_normalized_surrogate
from ..ops.integrators import step_fn
from ..solve.interior_point import IPConfig

# physics
MC, MP, L, G = 1.0, 0.1, 0.5, 9.81
H, DT = 50, 0.05
TIP_MAX = 0.55
F_MAX = 10.0
REPLAN_EVERY = 2
# hanging, with a small offset that breaks the exact saddle at θ = π where
# every gradient vanishes
X_HANGING = (0.0, 0.0, np.pi - 0.05, 0.0)
STATE_BOX = [[-2.0, 2.0], [-6.0, 6.0], [-2.0 * np.pi, 2.0 * np.pi],
             [-12.0, 12.0]]


def cartpole_f():
    """Continuous-time cartpole ``f(x, u)`` on (T, 4), (T, 1); x = [pos,
    vel, θ, ω], θ = 0 upright."""

    def f(x, u):
        vel, th, om = x[:, 1:2], x[:, 2:3], x[:, 3:4]
        F = u[:, 0:1]
        s, c = torch.sin(th), torch.cos(th)
        denom = MC + MP * s ** 2
        acc = (F + MP * s * (L * om ** 2 - G * c)) / denom
        alpha = (-F * c - MP * L * om ** 2 * s * c
                 + (MC + MP) * G * s) / (L * denom)
        return torch.cat([vel, acc, om, alpha], dim=1)

    return f


def cartpole_cost() -> StageCost:
    """Pay for the pole's potential-energy deficit, cart excursion, rates
    and effort; a terminal energy and rate term."""
    return StageCost(
        stage=lambda x, u: (3.0 * (1.0 - torch.cos(x[2]))
                            + 0.1 * x[0] ** 2 + 0.05 * x[1] ** 2
                            + 0.05 * x[3] ** 2 + 0.01 * torch.sum(u ** 2)),
        terminal=lambda x: 30.0 * (1.0 - torch.cos(x[2])) + 5.0 * x[3] ** 2)


def cartpole_box() -> Box:
    return Box.make(states_constraint=STATE_BOX,
                    control_constraint=[[-F_MAX, F_MAX]])


def tip_clearance():
    """|pos + L·sin θ| ≤ TIP_MAX on every stage."""
    return stage_interval(
        lambda x, u: torch.stack([x[0] + L * torch.sin(x[2])]),
        dim=1, lb=-TIP_MAX, ub=TIP_MAX)


def cartpole_features(x):
    """Angle-aware surrogate features: θ enters as (sin θ, cos θ)."""
    return torch.cat([x[:, :2], torch.sin(x[:, 2:3]), torch.cos(x[:, 2:3]),
                      x[:, 3:4]], dim=1)


def fit_cartpole_mlp(device="cuda", n: int = 131072, steps: int = 12000,
                     batch: int = 4096, seed: int = 0):
    """The ``--mlp`` surrogate: the JAX example's normalised fit (hidden
    [128, 128], (sin, cos) angle features).  Returns (model, params,
    rel_mse)."""
    gen = torch.Generator().manual_seed(seed)
    return fit_normalized_surrogate(
        cartpole_f(), gen, x_dim=4, u_dim=1, hidden=[128, 128], n=n,
        x_range=(-4.0, 4.0), u_range=(-12.0, 12.0), steps=steps, lr=1e-3,
        batch=batch, feature_map=cartpole_features, feature_dim=5,
        name="cartpole_mlp", device=device)


def make_cartpole_mpc(device="cuda", model=None, H: int = H,
                      max_iter: int = 120) -> NMPC:
    """The swing-up NMPC: RK4, the StageCost, the box and the tip row;
    the true dynamics unless ``model`` is given."""
    if model is None:
        model = torch_dynamics(cartpole_f(), x_dim=4, u_dim=1)
    return NMPC(model, cartpole_cost(), [cartpole_box(), tip_clearance()],
                H=H, DT=DT, integrator="rk4",
                config=IPConfig(max_iter=max_iter), device=device)


def swing_up(mpc: NMPC, steps: int, params=None, device="cuda"):
    """The closed loop: re-plan with :meth:`NMPC.next` every
    REPLAN_EVERY plant steps from the hanging start, the plant the true
    dynamics under RK4.  Returns (trajectory (steps+1, 4), forces (steps,),
    per-solve converged flags, per-solve blocking latencies in s)."""
    phi_true = step_fn(torch_dynamics(cartpole_f(), x_dim=4, u_dim=1),
                       "rk4", DT)
    mpc.reset()
    x = torch.tensor(X_HANGING, dtype=torch.float32, device=device)
    traj, us, conv, lat = [x], [], [], []
    plan, k = None, 0
    for t in range(steps):
        if t % REPLAN_EVERY == 0:
            t0 = time.perf_counter()
            res = mpc.next(x, params=params)
            conv.append(bool(res.converged))     # blocks on the solve
            lat.append(time.perf_counter() - t0)
            plan, k = res, 0
        u = plan.u[k]
        k += 1
        x = phi_true(x[None, :], u[None, :])[0]
        traj.append(x)
        us.append(u[0])
    return (torch.stack(traj).cpu().numpy(), torch.stack(us).cpu().numpy(),
            conv, lat)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--mlp", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--H", type=int, default=H)
    ap.add_argument("--max-iter", type=int, default=120)
    ap.add_argument("--fit-n", type=int, default=131072,
                    help="--mlp: transitions sampled")
    ap.add_argument("--fit-steps", type=int, default=12000,
                    help="--mlp: Adam steps")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    if args.mlp:
        model, params, rel_mse = fit_cartpole_mlp(
            device, n=args.fit_n, steps=args.fit_steps,
            batch=min(4096, args.fit_n))
        print(f"surrogate fitted: normalized mse={rel_mse:.2e}")
    else:
        model, params = None, None
    mpc = make_cartpole_mpc(device, model, H=args.H,
                            max_iter=args.max_iter)
    print("kkt backend:", mpc.kkt_backend)
    if mpc.kkt_backend != "riccati":
        raise RuntimeError("config 3 must run structured O(H), not dense")

    traj, us, conv, lat = swing_up(mpc, args.steps, params, device)
    # blocking re-plan latency (the first two solves left out, as the JAX
    # example leaves out its compiles)
    if len(lat) > 4:
        warm = np.asarray(lat[2:])
        print(f"re-plan latency (H={args.H}, nonlinear tip constraint, "
              f"riccati): p50={np.median(warm) * 1e3:.1f}ms  "
              f"min={warm.min() * 1e3:.1f}ms")
    cos_final = float(np.cos(traj[-1, 2]))
    tip_pos = traj[:, 0] + L * np.sin(traj[:, 2])
    print(f"solves converged: {sum(conv)}/{len(conv)}")
    print(f"final cos(theta): {cos_final:.3f}  (1.0 = upright)")
    print(f"cart pos range: [{traj[:, 0].min():.2f}, {traj[:, 0].max():.2f}]"
          f"  (box +-2)")
    print(f"tip clearance |pos + L sin(th)| max: {np.abs(tip_pos).max():.3f}"
          f"  (nonlinear constraint <= {TIP_MAX})")
    print(f"force range: [{us.min():.2f}, {us.max():.2f}]  (box +-10)")
    if not np.abs(traj[:, 0]).max() <= 2.01:
        raise RuntimeError("cart position bound violated")
    if not np.abs(tip_pos).max() <= TIP_MAX + 0.05:
        raise RuntimeError("tip clearance constraint violated in closed loop")
    return cos_final


if __name__ == "__main__":
    main()
