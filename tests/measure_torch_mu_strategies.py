"""Measure the solver options' μ rules on the LV MLP fleet in both
packages on the CPU: the fleet of ``chip_smoke.py`` phases 4 and 4i (the
2x32 tanh surrogate fitted eagerly to the normalised Lotka-Volterra system,
3000 Adam steps, bench.py's controller, H=20, the seeded starts), solved
cold, then re-planned once warm from the plans' first states, under each
``mu_strategy`` by the JAX package and by the port, with the same
weights.  Prints, for each package and rule: members converged (cold and
warm), iterations (max, mean), and against the same package's monotone
solve the members at the same solution (objectives within 1e-6,
relative), their largest |Δu|, and the members at another local
solution.

Run: python tests/measure_torch_mu_strategies.py [--batch N]

Not a test (a B=4096 run takes a few minutes): it gives the reference's
own numbers that chip_smoke.py's phase 4i gates are set against.
"""

import argparse
import sys
import time
from pathlib import Path

import jax
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402

import pyneuralempc_tpu as J  # noqa: E402
import pyneuralempc_tpu_torch as T  # noqa: E402

REG = 1e-4
BOX = dict(states_constraint=[[-1.0, 1.0], [-1.0, 0.35]],
           control_constraint=[[0.0, 1.2]])
CFG = dict(tol=1e-5, polish_iters=5, polish_mu=1e-9, warm_z_corridor=1e2,
           warm_mu=3e-4)
SAME_SOLUTION = 1e-6


def f_true(x, u):
    """Normalised controlled Lotka-Volterra (bench.py's ground truth)."""
    xr = 30.0 * (x + 1.0)
    ur = 50.0 * u
    d1 = 0.5 * xr[:, :1] - 0.025 * xr[:, :1] * xr[:, 1:]
    d2 = -0.5 * xr[:, 1:] + ur + 0.005 * xr[:, :1] * xr[:, 1:]
    return torch.cat([d1, d2], dim=1) / 30.0


def fleet(B):
    """The fitted surrogate's params (torch) and B seeded starts."""
    surrogate = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    gen = torch.Generator().manual_seed(0)
    X, U, Y = T.sample_transitions(f_true, gen, 8192, 2, 1,
                                   x_range=(-1.0, 1.2), u_range=(0.0, 1.2),
                                   device="cpu")
    params, _ = T.fit_surrogate(surrogate, X, U, Y, steps=3000, lr=2e-3,
                                batch=1024)
    rng = np.random.default_rng(0)
    x0s = np.stack([rng.uniform(0.2, 0.8, 4096),
                    rng.uniform(-0.9, -0.3, 4096)], axis=1)
    return params, x0s.astype(np.float32)[:B]


def solve(pkg, strategy, params, x0s):
    """A cold solve and one warm re-plan from its plans' first states (as
    chip_smoke.py's warm re-plans): the cold result's fields and the warm
    re-plan's converged count."""
    cfg = dict(CFG, mu_strategy=strategy)
    if pkg == "jax":
        mpc = J.NMPC(J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32]),
                     lambda x, u: 1.1 * jnp.sum(u) + REG * jnp.sum(u * u),
                     [J.DomainConstraint(**BOX)], H=20, DT=0.1,
                     integrator="rk4", config=J.IPConfig(**cfg))
        p = [{k: jnp.asarray(v.numpy()) for k, v in layer.items()}
             for layer in params]
        xs, arr = jnp.asarray(x0s), np.asarray
    else:
        mpc = T.NMPC(T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32]),
                     lambda x, u: 1.1 * torch.sum(u) + REG * torch.sum(u * u),
                     [T.DomainConstraint(**BOX)], H=20, DT=0.1,
                     integrator="rk4", config=T.IPConfig(**cfg),
                     device="cpu")
        p, xs, arr = params, torch.as_tensor(x0s), lambda t: t.numpy()
    carry, res = mpc.next_batch(xs, params=p)
    _, warm = mpc.next_batch(res.x[:, 0], params=p, carry=carry)
    out = {k: arr(getattr(res, k)) for k in
           ("u", "converged", "iterations", "objective")}
    out["warm_converged"] = int(arr(warm.converged).sum())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    args = ap.parse_args(argv)
    params, x0s = fleet(args.batch)
    B = len(x0s)
    for pkg in ("jax", "port"):
        mono = None
        for strategy in ("monotone", "adaptive", "mehrotra"):
            t0 = time.perf_counter()
            r = solve(pkg, strategy, params, x0s)
            line = (f"{pkg} {strategy}: converged {int(r['converged'].sum())}"
                    f"/{B}, iterations max {int(r['iterations'].max())} "
                    f"mean {float(r['iterations'].mean()):.2f}, a warm "
                    f"re-plan converged {r['warm_converged']}/{B} "
                    f"({time.perf_counter() - t0:.1f} s)")
            if mono is None:
                mono = r
            else:
                both = r["converged"] & mono["converged"]
                rel = (np.abs(r["objective"] - mono["objective"])
                       / np.maximum(np.abs(mono["objective"]), 1.0))
                same = both & (rel <= SAME_SOLUTION)
                du = np.abs(r["u"] - mono["u"]).max(axis=(1, 2))
                line += (f"; against monotone: both converged "
                         f"{int(both.sum())}, at the same solution "
                         f"{int(same.sum())} ({same.sum() / both.sum():.2%}),"
                         f" max |du| {du[same].max():.3e} there, at another "
                         f"local solution {int((both & ~same).sum())}")
            print(line, flush=True)


if __name__ == "__main__":
    main()
