"""Measure the dense backend and the ALM solver on the LV MLP fleet in both
packages on the CPU: the fleet of ``chip_smoke.py`` phases 4, 4k and 4l
(the 2x32 tanh surrogate fitted eagerly to the normalised Lotka-Volterra
system, 3000 Adam steps, bench.py's controller, H=20, the seeded starts;
``tests/measure_torch_mu_strategies.py``'s fleet).  For each package:

* the Riccati solve (``kkt="riccati"``, phase 4's), cold;
* ``kkt="dense"``, cold and ``--warm`` warm re-plans, each from the
  plans' first states (chip_smoke.py's protocol: one untimed and two
  timed): converged counts, and against the Riccati cold plans the
  members both converged, those at the same solution (objectives within
  1e-6, relative) and their largest |Δu|;
* bench.py's cost plus a move-suppression term 1e-3·Σ(u_{t+1} − u_t)²
  under ``kkt="auto"`` (the dense backend): cold and the warm re-plans;
* ``ALMConfig()`` on the first ``--alm-batch`` members, cold: converged
  count, outer iterations, and against the Riccati cold plans the members
  whose objectives agree to 1e-6, 1e-5, 1e-4 and 1e-3 (relative) and
  their largest |Δu|.

Run: python tests/measure_torch_dense_alm.py [--batch N] [--alm-batch N]
     [--chunk N] [--warm N] [--packages jax,port] [--kinds dense,moves,alm]
     [--members START:STOP]

Members solve independently, so the batch is solved in chunks of
``--chunk`` members (a member's answer does not depend on its chunk) to
bound the memory of the dense Hessians, and ``--members`` takes a range of
them, so that several processes can share the work: their counts add up
and their largest |Δu| is the largest of theirs.  Not a test (B=4096 takes many
minutes): it gives the reference's own numbers that chip_smoke.py's
phase 4k and 4l gates are set against.
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
from measure_torch_mu_strategies import BOX, CFG, REG, fleet  # noqa: E402

SAME_SOLUTION = 1e-6
MOVE = 1e-3


def controller(pkg, kind):
    """bench.py's controller in ``pkg`` ("jax" or "port"): ``kind`` is
    "riccati" (phase 4's: the cost probes separable under kkt="auto"),
    "dense", "moves" (the move-suppression cost, kkt="auto") or "alm"."""
    lib, npx = (J, jnp) if pkg == "jax" else (T, torch)

    def cost(x, u):
        c = 1.1 * npx.sum(u) + REG * npx.sum(u * u)
        if kind == "moves":
            c = c + MOVE * npx.sum((u[1:] - u[:-1]) ** 2)
        return c

    if kind == "alm":
        config = lib.ALMConfig()
    else:
        config = lib.IPConfig(**dict(CFG, kkt="dense" if kind == "dense"
                                     else "auto"))
    kw = {} if pkg == "jax" else {"device": "cpu"}
    mpc = lib.NMPC(lib.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32]),
                   cost, [lib.DomainConstraint(**BOX)], H=20, DT=0.1,
                   integrator="rk4", config=config, **kw)
    assert mpc.kkt_backend == {"moves": "dense"}.get(kind, kind), \
        mpc.kkt_backend
    return mpc


def run(pkg, kind, params, x0s, chunk, warm):
    """Cold solve (and ``warm`` warm re-plans) in chunks: numpy fields."""
    mpc = controller(pkg, kind)
    if pkg == "jax":
        p = [{k: jnp.asarray(v.numpy()) for k, v in layer.items()}
             for layer in params]

        def xs(a):
            return jnp.asarray(a)

        def arr(a):
            return np.asarray(a)
    else:
        p = params

        def xs(a):
            return torch.as_tensor(np.asarray(a))

        def arr(a):
            return a.detach().numpy()
    parts = []
    for i in range(0, len(x0s), chunk):
        carry, res = mpc.next_batch(xs(x0s[i:i + chunk]), params=p)
        out = {k: arr(getattr(res, k)) for k in
               ("u", "converged", "iterations", "objective")}
        w = res
        for k in range(warm):
            carry, w = mpc.next_batch(xs(arr(w.x[:, 0])), params=p,
                                      carry=carry)
            out[f"warm{k}_converged"] = arr(w.converged)
            out[f"warm{k}_iterations"] = arr(w.iterations)
        parts.append(out)
    return {k: np.concatenate([q[k] for q in parts]) for k in parts[0]}


def against(r, ref, thresholds=(SAME_SOLUTION,)):
    both = r["converged"] & ref["converged"][:len(r["converged"])]
    o = ref["objective"][:len(r["objective"])]
    rel = np.abs(r["objective"] - o) / np.maximum(np.abs(o), 1.0)
    du = np.abs(r["u"] - ref["u"][:len(r["u"])]).max(axis=(1, 2))
    parts = []
    for t in thresholds:
        same = both & (rel <= t)
        parts.append(f"objectives within {t:g}: {int(same.sum())}, max |du| "
                     f"{du[same].max() if same.any() else 0.0:.3e} there")
    return (f"against Riccati: both converged {int(both.sum())}; "
            + "; ".join(parts)
            + f"; max |du| on all both converged {du[both].max():.3e}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--alm-batch", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--packages", default="jax,port")
    ap.add_argument("--kinds", default="dense,moves,alm")
    ap.add_argument("--members", default=":")
    args = ap.parse_args(argv)
    params, x0s = fleet(args.batch)
    lo, hi = (int(v) if v else None for v in args.members.split(":"))
    kinds = args.kinds.split(",")
    if "dense" in kinds or "alm" in kinds:
        kinds = ["riccati"] + kinds     # the reference of both
    for pkg in args.packages.split(","):
        ref = None
        for kind in kinds:
            t0 = time.perf_counter()
            xs = (x0s[:args.alm_batch] if kind == "alm" else x0s)[lo:hi]
            if kind == "riccati" and "dense" not in kinds:   # ALM's members
                xs = x0s[:args.alm_batch][lo:hi]
            r = run(pkg, kind, params, xs, args.chunk,
                    warm=args.warm if kind in ("dense", "moves") else 0)
            n = len(xs)
            line = (f"{pkg} {kind}: converged {int(r['converged'].sum())}/"
                    f"{n}, iterations max {int(r['iterations'].max())} mean "
                    f"{float(r['iterations'].mean()):.2f}")
            for k in range(args.warm):
                if f"warm{k}_converged" in r:
                    line += (f", warm re-plan {k} converged "
                             f"{int(r[f'warm{k}_converged'].sum())}/{n} "
                             f"(max {int(r[f'warm{k}_iterations'].max())})")
            if kind == "riccati":
                ref = r
            elif kind == "dense":
                line += "; " + against(r, ref)
            elif kind == "alm":
                line += "; " + against(r, ref, (1e-6, 1e-5, 1e-4, 1e-3))
            if kind == "alm":
                hist = np.bincount(r["iterations"].astype(int))
                line += f"; outer iterations histogram {hist.tolist()}"
            print(line + f" ({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
