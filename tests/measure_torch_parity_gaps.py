"""Measure the JAX package's converged counts on the fleets of chip_smoke.py's
phases 4s-4u, on the CPU, for the gates there:

* ``stacked_lstm``: the stacked-LSTM fleet (``examples/fleet_rnn.py``
  ``lstm_fleet_model("stacked_lstm")``, lifted (34, 1), the GRU fleet's
  MPC, H=100), B=1024: a cold solve and 1 warm re-plan from the plans'
  first lifted states;
* ``lstm``: the single-LSTM fleet (lifted (18, 1)), B=4096: a cold solve
  and 2 warm re-plans;
* ``bf16``: bench.py's LV MLP fleet with ``compute_dtype=bfloat16``
  matmuls on the 2x32 surrogate fitted eagerly by the port on the CPU
  from chip_smoke.py's phase 4 seed (as tests/measure_torch_mu_strategies.py
  fits it), B=4096: a cold solve and 2 warm re-plans.

The LSTM weights are the port's seeded tensors, carried across as numpy.
Each fleet is solved with ``next_batch(batch_chunk=256)`` (the chunks keep
the CPU's memory small; a member's solve does not depend on the others').
``--packages jax,port`` also runs the port on the CPU.

Run: python tests/measure_torch_parity_gaps.py
     [--fleets stacked_lstm,lstm,bf16] [--packages jax] [--batch N]

Not a test: the JAX package's B=4096, H=100 solves take many minutes on
the CPU.
"""

import argparse
import sys
import time
from pathlib import Path

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import pyneuralempc_tpu as J  # noqa: E402
import pyneuralempc_tpu_torch as T  # noqa: E402

from _torch_lstm import lstm_fleets, starts  # noqa: E402
from _torch_lv import BENCH_CFG, BOX, REG, lv_true_torch  # noqa: E402

# fleet -> (B, warm re-plans)
FLEETS = {"stacked_lstm": (1024, 1), "lstm": (4096, 2), "bf16": (4096, 2)}
CHUNK = 256


def lv_bf16(pkg, B):
    """bench.py's fleet with bf16 matmuls in ``pkg``, its surrogate fitted
    eagerly by the port on the CPU (phase 4's seed and settings), and the
    first B of phase 4's seeded starts."""
    surrogate = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    gen = torch.Generator().manual_seed(0)
    X, U, Y = T.sample_transitions(lv_true_torch, gen, 8192, 2, 1,
                                   x_range=(-1.0, 1.2), u_range=(0.0, 1.2),
                                   device="cpu")
    params, _ = T.fit_surrogate(surrogate, X, U, Y, steps=3000, lr=2e-3,
                                batch=1024)
    rng = np.random.default_rng(0)
    x0s = np.stack([rng.uniform(0.2, 0.8, 4096),
                    rng.uniform(-0.9, -0.3, 4096)],
                   axis=1).astype(np.float32)[:B]
    if pkg == "jax":
        mpc = J.NMPC(J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32],
                                        compute_dtype=jnp.bfloat16),
                     lambda x, u: 1.1 * jnp.sum(u) + REG * jnp.sum(u * u),
                     [J.DomainConstraint(**BOX)], H=20, DT=0.1,
                     integrator="rk4", config=J.IPConfig(**BENCH_CFG))
        return mpc, [{k: jnp.asarray(v.numpy()) for k, v in layer.items()}
                     for layer in params], x0s
    mpc = T.NMPC(T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32],
                                    compute_dtype=torch.bfloat16),
                 lambda x, u: 1.1 * torch.sum(u) + REG * torch.sum(u * u),
                 [T.DomainConstraint(**BOX)], H=20, DT=0.1, integrator="rk4",
                 config=T.IPConfig(**BENCH_CFG), device="cpu")
    return mpc, params, x0s


def run(pkg, fleet, batch=None):
    """Converged counts and the largest iteration count, cold and at each
    warm re-plan (of the first ``batch`` members, where given)."""
    B, warm = FLEETS[fleet]
    B = batch or B
    if fleet == "bf16":
        mpc, params, x0s = lv_bf16(pkg, B)
    else:
        jm, jp, tm, tp, tb = lstm_fleets(fleet, 100)
        mpc, params = (jm, jp) if pkg == "jax" else (tm, tp)
        x0s = starts(tb, B)
    xs = jnp.asarray(x0s) if pkg == "jax" else torch.as_tensor(x0s)
    carry, res = mpc.next_batch(xs, params=params, batch_chunk=CHUNK)
    out = []
    for k in range(warm + 1):
        if k:
            carry, res = mpc.next_batch(res.x[:, 0], params=params,
                                        carry=carry, batch_chunk=CHUNK)
        out.append((int(np.asarray(res.converged).sum()),
                    int(np.asarray(res.iterations).max())))
    return B, out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--fleets", default=",".join(FLEETS))
    ap.add_argument("--packages", default="jax")
    ap.add_argument("--batch", type=int, default=None,
                    help="the first members only (a quick check)")
    args = ap.parse_args(argv)
    for fleet in args.fleets.split(","):
        for pkg in args.packages.split(","):
            t0 = time.perf_counter()
            B, out = run(pkg, fleet, args.batch)
            print(f"{pkg} {fleet} B={B}: converged (iterations max), cold "
                  "then each warm re-plan: "
                  + ", ".join(f"{c}/{B} ({i})" for c, i in out)
                  + f" ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
