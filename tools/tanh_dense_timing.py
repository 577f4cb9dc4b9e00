#!/usr/bin/env python3
"""Time the tanh layers' tangent kernels on the card, at the quadrotor MLP
cell's shapes, against what they replace.

    python3 tools/tanh_dense_timing.py [--kernels] [--blocks] [--batch B]

``--kernels``: K1 and K2 (``ops/cuda/tanh_dense.py``) at 102,400 primal
rows of 16 tangents (B=2048, H=50) and the layer widths of the cell's 2x256
MLP over 19 inputs: each kernel's device time (CUDA events over
back-to-back launches), the least time the card could take (float32 FFMA
at 67 TFLOP/s, or bytes at 3.35 TB/s), its plain version's time on the
card; then one layer's whole tangent pass as the stage blocks run it (a
``vmap`` over rows of a ``vmap`` over 16 tangents of ``jvp`` over ``vjp``)
composed from ATen ops, as before the kernels, against the same pass
through ``TanhLayers``.

``--blocks``: the stage blocks (``kkt.prepare``) of a quadrotor fleet
with a random 2x256 tanh MLP over the cell's features, RK4, H=50, B
members: device and host milliseconds of each ``kkt.prepare`` of a warm
re-plan, the layers as ATen ops (the parent's route) and through
``TanhLayers``, in turns.

Prints one JSON object a measurement, the card's name and power limit in
each; exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pyneuralempc_tpu_torch.models import mlp  # noqa: E402
from pyneuralempc_tpu_torch.ops.cuda import tanh_dense as td  # noqa: E402

F32_FLOPS = 67e12
HBM_BYTES = 3.35e12
P, T = 102_400, 16


def card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def emit(**rec):
    print(json.dumps(dict(rec, card=CARD)), flush=True)


def device_ms(fn, runs=20, warmup=3):
    """Milliseconds a call of ``fn`` between CUDA events, ``runs`` calls
    back to back after ``warmup``."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(runs):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / runs


def kernels():
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g)
    M = P * T
    for name, K, N in (("k1", 19, 256), ("k1", 256, 256), ("k2", 256, 256),
                       ("k2", 19, 256)):
        y, gy, W = torch.tanh(rand(P, N)), rand(P, N), rand(K, N) / K ** 0.5
        if name == "k1":
            hd = rand(P, T, K)
            call = lambda: td.tangent_fwd_cuda(hd, y, W)            # noqa
            plain = lambda: td.tangent_fwd_plain(hd, y, W)          # noqa
            nbytes = 4 * (M * K + M * N + P * N + K * N)
            flops = 2 * M * K * N + 3 * M * N
        else:
            gd, yd = rand(P, T, N), rand(P, T, N)
            call = lambda: td.tangent_vjp_cuda(gd, yd, gy, y, W)    # noqa
            plain = lambda: td.tangent_vjp_plain(gd, yd, gy, y, W)  # noqa
            nbytes = 4 * (2 * M * N + M * K + 2 * P * N + K * N)
            flops = 2 * M * K * N + 7 * M * N
        ms = device_ms(call)
        t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
        emit(what="kernel", kernel=name, P=P, T=T, K=K, N=N, ms=ms,
             bound_ms=max(t_ops, t_bytes),
             bound_by="flops" if t_ops >= t_bytes else "bytes",
             share=max(t_ops, t_bytes) / ms, plain_ms=device_ms(plain, 5, 1),
             gflop=flops / 1e9, gbytes=nbytes / 1e9)
        del call, plain
        torch.cuda.empty_cache()
    for K, N in ((19, 256), (256, 256)):
        h, gy = rand(P, 1, K), rand(P, 1, N)
        hd, W, b = rand(P, T, 1, K), rand(K, N) / K ** 0.5, rand(N) * 0.1
        row = {}
        for route, layer in (
                ("aten", lambda z: torch.tanh(z @ W + b)),
                ("tanh_layers", lambda z: mlp.TanhLayers.apply(z, W, b)[0])):
            def one(h1, g1, hd1, layer=layer):
                def f(z):
                    y, back = torch.func.vjp(layer, z)
                    return y, back(g1)[0]
                return torch.func.vmap(
                    lambda t: torch.func.jvp(f, (h1,), (t,))[1])(hd1)
            row[route] = device_ms(lambda: torch.func.vmap(one)(h, gy, hd),
                                   runs=5, warmup=1)
        emit(what="layer_pass", K=K, N=N, P=P, T=T, aten_ms=row["aten"],
             tanh_layers_ms=row["tanh_layers"])
        torch.cuda.empty_cache()


def blocks(batch, turns=("aten", "tanh_layers", "tanh_layers", "aten")):
    import pyneuralempc_tpu_torch as nempc
    from pyneuralempc_tpu_torch.examples.quadrotor import (
        make_quadrotor_mpc, quad_features, quad_x0s)
    from pyneuralempc_tpu_torch.utils import tracing
    import numpy as np

    prm = nempc.mlp_init(torch.Generator().manual_seed(0), (19, 256, 256, 12),
                         device="cuda")
    acts = ("tanh", "tanh", "linear")

    def surrogate(x, u, p, tvp, params):
        z = torch.cat([quad_features(x), u - 1.2], dim=-1)
        return 0.1 * nempc.mlp_apply(params, z, acts) + torch.cat(
            [x[:, 3:6], torch.zeros_like(x[:, 3:])], dim=-1)

    model = nempc.DynamicsModel(fn=surrogate, dims=nempc.Dims(12, 4),
                                name="quad_rand_mlp")
    mpc = make_quadrotor_mpc("cuda", model=model)
    x0 = torch.tensor(quad_x0s(np.random.default_rng(0), batch),
                      device="cuda")
    seen = []
    span = tracing.span

    @contextlib.contextmanager
    def timed(name, device=None, **attrs):
        if name != "kkt.prepare":
            with span(name, device, **attrs) as s:
                yield s
            return
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        t0 = time.perf_counter()
        yield span(name)
        seen.append((time.perf_counter() - t0, e0, e1))
        e1.record()

    least = mlp.FUSED_MIN_ELEMENTS
    tracing.span = timed
    try:
        carry, _ = mpc.next_batch(x0, params=prm)
        for route in turns:
            mlp.FUSED_MIN_ELEMENTS = (0 if route == "tanh_layers"
                                      else float("inf"))
            mpc.next_batch(x0, params=prm, carry=carry)   # warm the route
            del seen[:]
            launches = (td.K1_LAUNCHES, td.K2_LAUNCHES)
            t0 = time.perf_counter()
            _, res = mpc.next_batch(x0, params=prm, carry=carry)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            emit(what="blocks", route=route, B=batch,
                 replan_ms=wall * 1e3,
                 iterations=int(res.iterations.max()),
                 prepare_device_ms=[e0.elapsed_time(e1) for _, e0, e1 in seen],
                 prepare_host_ms=[h * 1e3 for h, _, _ in seen],
                 k1=td.K1_LAUNCHES - launches[0],
                 k2=td.K2_LAUNCHES - launches[1])
    finally:
        tracing.span = span
        mlp.FUSED_MIN_ELEMENTS = least


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", action="store_true")
    ap.add_argument("--blocks", action="store_true")
    ap.add_argument("--batch", type=int, default=2048)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    global CARD
    CARD = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.kernels:
        kernels()
    if args.blocks:
        blocks(args.batch)
    return 0


CARD = None

if __name__ == "__main__":
    sys.exit(main())
