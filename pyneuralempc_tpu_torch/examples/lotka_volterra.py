"""Closed-loop economic MPC on the controlled Lotka-Volterra system.

The port's copy of the JAX package's ``examples/lotka_volterra.py``.  The
normalisation is carried through the dynamics: x_n = x/30 − 1, u_n = u/50.

System (raw units): prey x₁~[0,60], predator x₂~[0,40], feed rate u∈[0,60]:

    ẋ₁ = 0.5·x₁ − 0.025·x₁·x₂
    ẋ₂ = −0.5·x₂ + u + 0.005·x₁·x₂

Economics: feeding the predators costs 1.1/unit; the farm must keep the
prey population under a hard cap.  The MPC feeds as little as possible
while honouring the cap — a pure economic cost with an active state
constraint, no tracking term.

Beside the example, the budgeted LV fleet: bench.py's workload (its box,
its cost 1.1·Σu + 1e-4·Σu², its ``IPConfig``, H=20) with a minimum feed
delivery over the horizon, Σ_t u_t ≥ :data:`U_FLOOR` (a supplier's minimum
order per planning window): one trajectory-level row with a slack, so its
KKT systems take the general sweep with R = 2 right-hand sides and r = 0
(on the card, ``csrc/riccati_general_fused.cu``).

Run:  python -m pyneuralempc_tpu_torch.examples.lotka_volterra [--mlp]
      [--steps N] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..api.controller import NMPC
from ..core.problem import Box, PathConstraint
from ..models.base import torch_dynamics
from ..models.mlp import MLPDynamics
from ..models.train import fit_surrogate, sample_transitions
from ..ops.integrators import step_fn
from ..solve.interior_point import IPConfig

# Chosen once: the unbudgeted fleet (true ODE as the model, bench.py's
# cost, box and IPConfig, H=20) solved cold on the CPU port from the first
# 256 of chip_smoke.py's B=4096 x0 draw (seed 0) gives plans whose Σu has
# its 30th percentile at 0.460 (16% of them feed nothing); rounded to 0.5.
# tests/test_torch_lv_budget.py::test_u_floor_is_the_cold_plans_30th_percentile
# repeats that solve.
U_FLOOR = 0.5
REG = 1e-4
BENCH_BOX = dict(states_constraint=[[-1.0, 1.0], [-1.0, 0.35]],
                 control_constraint=[[0.0, 1.2]])
BENCH_CONFIG = dict(tol=1e-5, polish_iters=5, polish_mu=1e-9,
                    warm_z_corridor=1e2, warm_mu=3e-4)


def normalized_lv():
    """Normalized dynamics, properly transformed:
    dx_n/dt = f_raw(30(x_n+1), 50·u_n) / 30, on (T, 2), (T, 1)."""

    def f(x, u):
        xr = 30.0 * (x + 1.0)
        ur = 50.0 * u
        d1 = 0.5 * xr[:, :1] - 0.025 * xr[:, :1] * xr[:, 1:]
        d2 = -0.5 * xr[:, 1:] + ur + 0.005 * xr[:, :1] * xr[:, 1:]
        return torch.cat([d1, d2], dim=1) / 30.0

    return f


def feed_floor() -> PathConstraint:
    """Σ_t u_t ≥ U_FLOOR over the horizon."""
    return PathConstraint(fn=lambda x, u: u.sum(dim=0), dim=1,
                          lb=(U_FLOOR,), ub=(float("inf"),))


def bench_cost(x, u):
    """bench.py's economic cost: feed at 1.1 a unit, 1e-4·Σu² beside it."""
    return 1.1 * torch.sum(u) + REG * torch.sum(u * u)


# BASELINE config 1: the known ODE as the model, Euler, H=10, one solve
# from the reference example's start (prey 50, predators 5).
CONFIG1_X0 = (50.0 / 30 - 1, 5.0 / 30 - 1)


def make_config1_mpc(device="cuda") -> NMPC:
    """BASELINE config 1's NMPC: the normalised LV ODE itself as the
    model, the example's feed cost 1.1·Σu and box, Euler, H=10, DT=0.1;
    its one solve is ``next(torch.tensor(CONFIG1_X0))``."""
    return NMPC(torch_dynamics(normalized_lv(), x_dim=2, u_dim=1),
                lambda x, u: torch.sum(u * 1.1), [Box.make(**BENCH_BOX)],
                H=10, DT=0.1, integrator="euler", device=device)


def make_budget_mpc(model, device="cuda", H: int = 20,
                    DT: float = 0.1) -> NMPC:
    """The budgeted LV fleet's NMPC for ``model`` (the surrogate or the
    true ODE)."""
    return NMPC(model, bench_cost, [Box.make(**BENCH_BOX), feed_floor()],
                H=H, DT=DT, integrator="rk4",
                config=IPConfig(**BENCH_CONFIG), device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mlp", action="store_true",
                    help="use a trained MLP surrogate instead of the ODE")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    H, DT = 25, 0.1
    f_true = normalized_lv()
    truth = torch_dynamics(f_true, x_dim=2, u_dim=1)

    if args.mlp:
        surrogate = MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
        gen = torch.Generator()
        gen.manual_seed(0)
        X, U, Y = sample_transitions(f_true, gen, 8192, 2, 1,
                                     x_range=(-1.0, 1.2),
                                     u_range=(0.0, 1.2), device=device)
        params, mse = fit_surrogate(surrogate, X, U, Y, steps=3000, lr=2e-3,
                                    batch=1024)
        print(f"surrogate fitted: mse={mse:.2e}")
        model = surrogate
    else:
        model, params = truth, None

    # economics: feed cost, prey cap at raw 60 (normalized 1.0)
    mpc = NMPC(model, lambda x, u: torch.sum(u * 1.1),
               [Box.make(**BENCH_BOX)], H=H, DT=DT, integrator="rk4",
               device=device)

    # plant: ground-truth ODE, re-plan every 2 steps (the reference
    # example's REFRESH_EVERY=2)
    phi_true = step_fn(truth, "rk4", DT)
    x = torch.tensor([50.0 / 30 - 1, 5.0 / 30 - 1], device=device)
    traj, us, feed_cost, n_conv = [x], [], 0.0, 0
    plan, k = None, 0
    for t in range(args.steps):
        if t % 2 == 0:
            res = mpc.next(x, params=params)
            plan, k = res, 0
            n_conv += int(bool(res.converged))
        u = plan.u[k]
        k += 1
        x = phi_true(x[None, :], u[None, :])[0]
        traj.append(x)
        us.append(float(u[0]))
        feed_cost += 1.1 * float(u[0]) * DT

    traj = torch.stack(traj).cpu().numpy()
    prey = 30.0 * (traj[:, 0] + 1)
    pred = 30.0 * (traj[:, 1] + 1)
    print(f"solves converged: {n_conv}/{(args.steps + 1) // 2}")
    print(f"prey  range: [{prey.min():6.2f}, {prey.max():6.2f}]  (cap 60)")
    print(f"pred  range: [{pred.min():6.2f}, {pred.max():6.2f}]")
    print(f"feed  range: [{50*min(us):6.2f}, {50*max(us):6.2f}]")
    print(f"total feed cost: {50*feed_cost:.2f}")
    assert np.max(prey) <= 60.5, "prey cap violated"


if __name__ == "__main__":
    main()
