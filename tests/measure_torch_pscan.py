"""Measure the parallel-in-time Riccati backend on the long-horizon LV fleet
in both packages on the CPU: the fleet of ``chip_smoke.py`` phases 4p and
4q (``tools/bench_horizon_tpu.py``'s ``build_mpc``: the normalised
Lotka-Volterra ODE itself as the model, RK4, the cost 1.1·Σu, the box,
H=512, DT=2/H, tol 1e-5; its seeded starts), solved cold and then
re-planned ``--warm`` times warm from the plans' first states (that
script's protocol), under ``kkt="riccati"`` and ``kkt="riccati_pscan"``.

Prints, for each package, batch and backend: members converged and the
largest iteration count, cold and at each warm re-plan; then, for each
step, the largest pscan-vs-riccati |Δu| over the members converged under
both backends (and over all members).

Run: python tests/measure_torch_pscan.py [--batches 256,8] [--H 512]
     [--warm 3] [--packages jax,port] [--backends riccati,riccati_pscan]
     [--sweeps]

With ``--sweeps``, it prints instead the port's own sweep errors on the
CPU that chip_smoke.py's phase 4o and 4q gates are set at twice of: the
parallel-in-time sweep against the plain sequential one on the seeded
cases at (B, H, nx, nu) = (256, 512, 2, 1) and (64, 50, 12, 4), and the
horizon-sharded sweep on a (2, 4) mesh of the CPU at the first
(``sweep_cases.scaled_error``).

Not a test (the JAX package's pscan solve at B=256 takes minutes on the
CPU): it gives the reference's own numbers that chip_smoke.py's phase 4p
and 4q gates are set against.
"""

import argparse
import sys
import time
from pathlib import Path

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import pyneuralempc_tpu as J  # noqa: E402
import pyneuralempc_tpu_torch as T  # noqa: E402

BOX = dict(states_constraint=[[-1.0, 1.0], [-1.0, 0.35]],
           control_constraint=[[0.0, 1.2]])
BACKENDS = ("riccati", "riccati_pscan")


def lv(cat):
    def f_true(x, u):
        xr = 30.0 * (x + 1.0)
        ur = 50.0 * u
        d1 = 0.5 * xr[:, :1] - 0.025 * xr[:, :1] * xr[:, 1:]
        d2 = -0.5 * xr[:, 1:] + ur + 0.005 * xr[:, :1] * xr[:, 1:]
        return cat([d1, d2], 1) / 30.0
    return f_true


def controller(pkg, H, kkt):
    """``build_mpc(H, kkt)`` in ``pkg`` ("jax" or "port", on the CPU)."""
    if pkg == "jax":
        lib, npx = J, jnp
        model = J.jax_dynamics(lv(jnp.concatenate),
                               x_dim=2, u_dim=1)
        kw = {}
    else:
        lib, npx = T, torch
        model = T.torch_dynamics(lv(torch.cat), x_dim=2, u_dim=1)
        kw = {"device": "cpu"}
    cost = lib.StageCost(stage=lambda x, u: 1.1 * npx.sum(u))
    mpc = lib.NMPC(model, cost, [lib.DomainConstraint(**BOX)], H=H,
                   DT=2.0 / H, integrator="rk4",
                   config=lib.IPConfig(tol=1e-5, kkt=kkt), **kw)
    assert mpc.kkt_backend == kkt, mpc.kkt_backend
    return mpc


def starts(B):
    """``tools/bench_horizon_tpu.py``'s ``measure`` starts."""
    rng = np.random.default_rng(0)
    return np.stack([rng.uniform(0.2, 0.8, B), rng.uniform(-0.9, -0.3, B)],
                    axis=1).astype(np.float32)


def run(pkg, B, H, kkt, warm):
    """Cold solve and ``warm`` warm re-plans: per step, numpy u, converged
    and iterations."""
    mpc = controller(pkg, H, kkt)
    if pkg == "jax":
        xs, arr = jnp.asarray, np.asarray
    else:
        xs, arr = torch.as_tensor, (lambda a: a.detach().numpy())
    carry, res = mpc.next_batch(xs(starts(B)))
    steps = []
    for k in range(warm + 1):
        if k:
            carry, res = mpc.next_batch(res.x[:, 0], carry=carry)
        steps.append({f: arr(getattr(res, f)) for f in
                      ("u", "converged", "iterations")})
    return steps


SWEEP_SHAPES = ((256, 512, 2, 1), (64, 50, 12, 4))
SWEEP_CASES = {"delta0": 0, "delta_rescue": 4}


def sweep_errors():
    """The pscan and horizon-sharded sweeps against the plain one."""
    from pyneuralempc_tpu_torch.ops.cuda import sweep_cases
    from pyneuralempc_tpu_torch.ops.cuda.riccati_kernel import (
        riccati_sweep_plain)
    from pyneuralempc_tpu_torch.parallel import (make_horizon_mesh,
                                                 make_sharded_sweep)
    from pyneuralempc_tpu_torch.solve.pscan import riccati_sweep_pscan
    sharded = make_sharded_sweep(make_horizon_mesh(2, 4, devices=["cpu"] * 8))
    for Bn, H, nx, nu in SWEEP_SHAPES:
        for kind, seed in SWEEP_CASES.items():
            args = [torch.as_tensor(a) for a in sweep_cases.sweep_case(
                kind, B=Bn, H=H, nx=nx, nu=nu, seed=seed)]
            ref = riccati_sweep_plain(*args)
            line = f"sweep {kind} (B, H, nx, nu) = {(Bn, H, nx, nu)}:"
            for name, fn in (("pscan", riccati_sweep_pscan),
                             ("horizon (2, 4)", sharded)):
                if name != "pscan" and (nx, kind) != (2, "delta0"):
                    continue
                out = fn(*args)
                same = bool(torch.equal(out[3], ref[3]))
                err = sweep_cases.scaled_error(out[:3], ref[:3], ref[3])
                line += (f" {name} vs plain scaled error {err:.3e} (ok "
                         f"{int(out[3].sum())}/{Bn}, equal to plain's: "
                         f"{same});")
            print(line, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="256,8")
    ap.add_argument("--H", type=int, default=512)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--packages", default="jax")
    ap.add_argument("--backends", default=",".join(BACKENDS))
    ap.add_argument("--sweeps", action="store_true")
    args = ap.parse_args(argv)
    backends = args.backends.split(",")
    if args.sweeps:
        return sweep_errors()
    for pkg in args.packages.split(","):
        for B in (int(b) for b in args.batches.split(",")):
            out = {}
            for kkt in backends:
                t0 = time.perf_counter()
                out[kkt] = run(pkg, B, args.H, kkt, args.warm)
                print(f"{pkg} B={B} H={args.H} {kkt}: converged, iterations "
                      "max (cold, then each warm re-plan) "
                      + ", ".join(f"{int(s['converged'].sum())}/{B} "
                                  f"{int(s['iterations'].max())}"
                                  for s in out[kkt])
                      + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
            if len(out) < 2:
                continue
            for k, (a, b) in enumerate(zip(*(out[kkt] for kkt in BACKENDS))):
                both = a["converged"] & b["converged"]
                du = np.abs(a["u"] - b["u"]).max(axis=(1, 2))
                print(f"{pkg} B={B} {'cold' if k == 0 else f'warm {k - 1}'}: "
                      f"pscan vs riccati max |du| {du[both].max():.3e} on "
                      f"the {int(both.sum())} members converged under both, "
                      f"{du.max():.3e} on all", flush=True)


if __name__ == "__main__":
    main()
