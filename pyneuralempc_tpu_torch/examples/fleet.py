"""Fleet-scale MPC: thousands of concurrent quadrotor MPC solves as one
batch, receding-horizon with warm carries, and optionally the whole fleet
closed loop (plant stepping, warm re-plans, failure policy) through
:func:`~pyneuralempc_tpu_torch.api.simulate.closed_loop_batch`.

The port's copy of the JAX package's ``examples/fleet.py``.  ``--mesh N``
shards the fleet over N devices (:class:`~pyneuralempc_tpu_torch.parallel.
ShardedNMPC`): the first N CUDA devices, or N shards on the CPU under
``--cpu``.

Run:  python -m pyneuralempc_tpu_torch.examples.fleet [--cpu]
      [--batch 16384] [--H 50] [--steps 5] [--mesh N] [--closed-loop T]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..api.controller import NMPC
from ..api.simulate import closed_loop_batch, plant_from_model
from ..models.base import torch_dynamics
from ..parallel.sharding import ShardedNMPC, make_mesh
from ..solve.interior_point import IPConfig
from .quadrotor import quad_box, quad_cost, quad_f, quad_x0s


def mesh_of(n: int, device):
    """``--mesh n``: the first n CUDA devices, or n shards on the CPU."""
    return make_mesh(n, devices=[device] * n if device == "cpu" else None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--H", type=int, default=50)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard over this many devices (0 = no sharding)")
    ap.add_argument("--closed-loop", type=int, default=0, metavar="T",
                    help="also run a T-step closed-loop fleet evaluation "
                         "(cost + violations)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    H, DT, B = args.H, 0.02, args.batch
    truth = torch_dynamics(quad_f(), x_dim=12, u_dim=4)
    cost = quad_cost()
    mpc = NMPC(truth, cost, [quad_box()], H=H, DT=DT, integrator="rk4",
               config=IPConfig(max_iter=60), device=device)
    print(f"device={device}  kkt={mpc.kkt_backend}  B={B}  H={H}")

    x0s = torch.as_tensor(quad_x0s(np.random.default_rng(0), B),
                          device=device)
    runner = mpc
    if args.mesh:
        runner = ShardedNMPC(mpc, mesh_of(args.mesh, device))
        print(f"scenario-sharded over {args.mesh} devices "
              f"({B // args.mesh} problems/device)")
    t0 = time.perf_counter()
    carry, res = runner.next_batch(x0s)
    sync()
    print(f"cold fleet solve: {time.perf_counter() - t0:.1f}s  "
          f"converged {int(res.converged.sum())}/{B}")

    # receding horizon: plant = plan head (perfect-model fleet rollout)
    carry, res = runner.next_batch(res.x[:, 0].contiguous(), carry=carry)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        carry, res = runner.next_batch(res.x[:, 0].contiguous(),
                                       carry=carry)
    sync()
    dt_step = (time.perf_counter() - t0) / max(args.steps, 1)
    print(f"warm fleet step: {dt_step * 1e3:.0f}ms -> "
          f"{B / dt_step:,.0f} solves/s  "
          f"(converged {int(res.converged.sum())}/{B})")

    if args.closed_loop:
        # the whole fleet closed loop: plant stepping, warm re-plans and the
        # failure policy on the device; the host reads the trajectories at
        # the end
        plant = plant_from_model(truth, "rk4", DT)
        T = args.closed_loop
        t0 = time.perf_counter()
        out = closed_loop_batch(mpc, plant, x0s, steps=T)
        sync()
        dt = time.perf_counter() - t0
        # closed-loop economic cost of the APPLIED trajectory
        stage_v = torch.func.vmap(cost.stage)
        cl_cost = stage_v(out.x[1:].reshape(-1, 12),
                          out.u.reshape(-1, 4)).reshape(T, B).sum(dim=0)
        lb, ub = mpc.nlp.spec.box.tile(1, device=device)
        viol = torch.clamp(torch.maximum(lb[:12] - out.x[1:],
                                         out.x[1:] - ub[:12]), min=0.0)
        conv = out.converged
        print(f"closed loop: {T} steps x {B} plants in {dt:.1f}s "
              f"({T * B / dt:,.0f} solves/s)")
        print(f"  mean closed-loop cost {float(cl_cost.mean()):.3f}  "
              f"worst {float(cl_cost.max()):.3f}")
        print(f"  max state-box violation {float(viol.max()):.2e}  "
              f"solves converged {int(conv.sum())}/{conv.numel()}")


if __name__ == "__main__":
    main()
