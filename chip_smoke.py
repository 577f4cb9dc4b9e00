#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, on failure):

1. Device: the card's name and power limit, torch and CUDA versions; TF32
   matmuls off.  No CUDA device -> exit 1 with no result.
2. Build: nvcc compiles the main path's kernel from the checkout's source
   (pyneuralempc_tpu_torch/csrc/riccati_sweep.cu).
3. Kernel vs plain: the kernel against its plain PyTorch version at the
   main path's shapes (B=4096, H=20, nx=2, nu=1) on four seeded cases, with
   its median device time (the kernel's own events in a torch.profiler
   trace), its time per wrapper call (CUDA events, host work included), the
   plain version's time and the least time the card could take (bound).
4. Main path: trains the 2x32 tanh MLP surrogate of the Lotka-Volterra
   system on the card, builds NMPC as bench.py does, solves B=4096 cold and
   then warm re-plans, the plant advanced by the true ODE through the port's
   RK4.  Launch counters are zeroed just before and read just after: the
   kernel must have launched and the plain sweep must not have run.
5. Card vs CPU: 16 of those problems solved on the card and on the CPU.
6. Numbers: warm re-plan p50 latency, solves/s and the time split.

The last two lines of stdout are the kernels' JSON line and
``{"ok": true, "device": {...}}``.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B, H, DT, REG = 4096, 20, 0.1, 1e-4
WARM_STEPS = 8
MIN_WARM_CONVERGED = 4092
# kernel vs plain, f32: every element within SWEEP_TOL·max(1, |plain|), and
# every output within SWEEP_TOL·max(1, max|plain|) absolute (dLam reaches
# ~80 on the delta=10 problems, where one f32 ulp is already ~8e-6)
SWEEP_TOL = 2e-5
CARD_VS_CPU_DU = 1e-4
N_CARD_VS_CPU = 16
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
TPU_SITE = "pyneuralempc_tpu/ops/pallas/riccati_kernel.py:445"


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def f_true(x, u):
    """Normalized controlled Lotka-Volterra (bench.py's ground truth)."""
    xr = 30.0 * (x + 1.0)
    ur = 50.0 * u
    d1 = 0.5 * xr[:, :1] - 0.025 * xr[:, :1] * xr[:, 1:]
    d2 = -0.5 * xr[:, 1:] + ur + 0.005 * xr[:, :1] * xr[:, 1:]
    return torch.cat([d1, d2], dim=1) / 30.0


# ---- phase 3: kernel vs plain ----

def sweep_case(kind, seed, dev, Bn=B, Hn=H, nx=2, nu=1):
    """Seeded sweep inputs with exactly symmetric G and M (the kernel reads
    upper triangles, the plain version full matrices)."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    ns = nx + nu

    def normal(*shape, std=1.0):
        return std * torch.randn(shape, generator=g, device=dev)

    A = torch.eye(nx, device=dev) + 0.1 * normal(Bn, Hn, nx, nx, std=0.3)
    Bm = 0.1 * normal(Bn, Hn, nx, nu)
    G = normal(Bn, Hn, ns, ns, std=0.05)
    G = 0.5 * (G + G.mT)
    M = normal(Bn, Hn, ns, ns, std=0.1)
    M = 0.5 * (M + M.mT) + torch.eye(ns, device=dev)
    mx = normal(Bn, Hn, nx)
    mu = normal(Bn, Hn, nu)
    c = normal(Bn, Hn, nx, std=0.1)
    delta = torch.zeros(Bn, device=dev)
    if kind == "delta_per_problem":
        delta = torch.tensor([0.0, 0.1, 1.0, 10.0], device=dev).repeat(
            Bn // 4)
    elif kind == "negative_curvature":
        M[1::2, :, nx, nx] = -50.0          # every odd problem indefinite
    elif kind == "local_bump":
        # Quu = Muu + Guu exactly at stage 1 (B = 0 there), set just below
        # zero: rescued at the 1e-6 bump (odd problems) or only at the
        # 1e-4 bump (problems 2 mod 4), with Qux and qu decoupled so the
        # rescued gains stay bounded
        for sel, gap in ((slice(1, None, 2), 2e-7), (slice(2, None, 4), 2e-5)):
            Bm[sel, 1] = 0.0
            M[sel, 1, nx, nx] = -G[sel, 1, nx, nx] - gap
            M[sel, 1, :nx, nx] = 0.0
            M[sel, 1, nx, :nx] = 0.0
            G[sel, 1, :nx, nx] = 0.0
            G[sel, 1, nx, :nx] = 0.0
            mu[sel, 1] = 0.0
    return [t.contiguous() for t in (A, Bm, G, M, mx, mu, c, delta)]


def cuda_median_ms(fn, runs=25, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def kernel_device_ms(fn, kernel_name, runs=25):
    """Median device time of the kernels named ``kernel_name`` over ``runs``
    calls of ``fn``, read from a torch.profiler trace.  When the trace holds
    no such kernel, the median of ``runs`` back-to-back calls between one
    CUDA event pair (host work included where the host is the slower)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel_name in e.name]
    if times:
        return statistics.median(times), f"profiler, {len(times)} kernels"
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    stop.record()
    stop.synchronize()
    return (start.elapsed_time(stop) / runs,
            f"events over {runs} back-to-back calls")


def phase_kernels(rk):
    cases = {"delta0": 0, "delta_per_problem": 1, "negative_curvature": 2,
             "local_bump": 3}
    worst_abs, worst_scaled = 0.0, 0.0
    for kind, seed in cases.items():
        args = sweep_case(kind, seed, "cuda")
        out = rk.riccati_sweep_cuda(*args)
        torch.cuda.synchronize()
        ref = rk.riccati_sweep_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(out[3], ref[3]):
            raise RuntimeError(f"{kind}: ok flags differ on "
                               f"{int((out[3] != ref[3]).sum())} problems")
        ok = ref[3]
        if kind == "negative_curvature":
            want = torch.arange(B, device="cuda") % 2 == 0
        else:
            want = torch.ones(B, dtype=torch.bool, device="cuda")
        if not torch.equal(ok, want):
            raise RuntimeError(f"{kind}: ok flags {int(ok.sum())}/{B}, "
                               f"expected {int(want.sum())}")
        abs_err, scaled = 0.0, 0.0
        for label, o, r in zip(("dX", "dU", "dLam"), out[:3], ref[:3]):
            d = (o - r).abs()[ok]
            mag = max(1.0, float(r[ok].abs().max()))
            err = float(d.max())
            if not err <= SWEEP_TOL * mag:
                raise RuntimeError(f"{kind}: kernel {label} differs from the "
                                   f"plain sweep by {err:.3e} > "
                                   f"{SWEEP_TOL} * {mag:.3g}")
            abs_err = max(abs_err, err)
            scaled = max(scaled, float((d / r.abs()[ok].clamp(min=1.0))
                                       .max()))
        log(f"kernel vs plain [{kind}]: ok {int(ok.sum())}/{B} (equal), "
            f"max |diff| {abs_err:.3e} (each output within {SWEEP_TOL} x "
            f"max(1, max|plain|)), max |diff|/max(1,|plain|) {scaled:.3e}")
        if not scaled <= SWEEP_TOL:
            raise RuntimeError(f"{kind}: kernel differs from the plain "
                               f"sweep by {scaled:.3e} > {SWEEP_TOL}")
        worst_abs = max(worst_abs, abs_err)
        worst_scaled = max(worst_scaled, scaled)

    args = sweep_case("delta0", 0, "cuda")
    ms, how = kernel_device_ms(lambda: rk.riccati_sweep_cuda(*args),
                               "riccati_sweep_kernel")
    call_ms = cuda_median_ms(lambda: rk.riccati_sweep_cuda(*args))
    plain_ms = cuda_median_ms(lambda: rk.riccati_sweep_plain(*args), runs=20)
    nbytes = rk.sweep_bytes(B, H, 2, 1)
    flops = rk.sweep_flops(B, H, 2, 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"riccati_sweep kernel: device time median {ms * 1e3:.2f} us "
        f"({how}); {call_ms * 1e3:.1f} us per wrapper call (host work "
        f"included); plain PyTorch {plain_ms:.3f} ms; bound "
        f"{bound_ms * 1e3:.2f} us "
        f"({nbytes / 1e6:.2f} MB at 3.35 TB/s vs {flops / 1e6:.1f} Mflop "
        f"at 67 TFLOP/s) -> roofline share {bound_ms / ms:.2%}")
    return {"name": "riccati_sweep", "route": "cuda",
            "source": "pyneuralempc_tpu_torch/csrc/riccati_sweep.cu",
            "replaces": TPU_SITE, "launches": 0,
            "max_abs_err": worst_abs, "max_scaled_err": worst_scaled,
            "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


# ---- phase 4: main path ----

def make_controller(nempc, device):
    surrogate = nempc.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    box = nempc.DomainConstraint(states_constraint=[[-1.0, 1.0],
                                                    [-1.0, 0.35]],
                                 control_constraint=[[0.0, 1.2]])
    cfg = nempc.IPConfig(tol=1e-5, polish_iters=5, polish_mu=1e-9,
                         warm_z_corridor=1e2, warm_mu=3e-4)
    return nempc.NMPC(surrogate,
                      lambda x, u: 1.1 * torch.sum(u) + REG * torch.sum(u * u),
                      [box], H=H, DT=DT, integrator="rk4", config=cfg,
                      device=device)


def telemetry(tag, res):
    it = res.iterations.float()
    return (f"{tag}: converged {int(res.converged.sum())}/"
            f"{res.converged.numel()}  iterations mean {float(it.mean()):.2f}"
            f" max {int(it.max())}  restorations "
            f"{int(res.restorations.sum())}")


def phase_main_path(nempc, rk, card):
    from pyneuralempc_tpu_torch.ops.integrators import step_fn

    t0 = time.perf_counter()
    surrogate = nempc.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    gen = torch.Generator()
    gen.manual_seed(0)
    X, U, Y = nempc.sample_transitions(f_true, gen, 8192, 2, 1,
                                       x_range=(-1.0, 1.2),
                                       u_range=(0.0, 1.2), device="cuda")
    params, mse = nempc.fit_surrogate(surrogate, X, U, Y, steps=3000,
                                      lr=2e-3, batch=1024)
    torch.cuda.synchronize()
    log(f"surrogate trained on the card: mse {mse:.2e} "
        f"({time.perf_counter() - t0:.1f} s, 3000 Adam steps)")

    mpc = make_controller(nempc, "cuda")
    log(f"kkt backend: {mpc.kkt_backend}; sweep plan: "
        f"{rk.kernel_plan(H, 2, 1, 'cuda')}")
    rng = np.random.default_rng(0)
    x0s = np.stack([rng.uniform(0.2, 0.8, B), rng.uniform(-0.9, -0.3, B)],
                   axis=1).astype(np.float32)
    plant = step_fn(nempc.torch_dynamics(f_true, 2, 1), "rk4", DT)

    rk.LAUNCHES = 0
    rk.PLAIN_CALLS = 0
    t0 = time.perf_counter()
    xs = torch.as_tensor(x0s, device="cuda")
    carry, res = mpc.next_batch(xs, params=params)
    torch.cuda.synchronize()
    log(f"cold B={B}: {time.perf_counter() - t0:.2f} s  "
        + telemetry("cold", res))
    times, conv, launches = [], [], []
    for step in range(WARM_STEPS):
        xs = plant(xs, res.u[:, 0])
        torch.cuda.synchronize()
        n0 = rk.LAUNCHES
        t0 = time.perf_counter()
        carry, res = mpc.next_batch(xs, params=params, carry=carry)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        conv.append(int(res.converged.sum()))
        launches.append(rk.LAUNCHES - n0)
        log(f"warm {step}: {times[-1] * 1e3:.1f} ms  sweeps "
            f"{launches[-1]}  " + telemetry("warm", res))
    main_launches, plain_calls = rk.LAUNCHES, rk.PLAIN_CALLS
    log(f"main path: riccati_sweep kernel launches {main_launches}, plain "
        f"sweep calls {plain_calls}")
    if main_launches <= 0 or plain_calls != 0:
        raise RuntimeError("the main path did not go through the kernel")
    if min(conv) < MIN_WARM_CONVERGED:
        raise RuntimeError(f"warm convergence {conv} below "
                           f"{MIN_WARM_CONVERGED}/{B}")
    for t in (res.u, res.x, res.objective):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite plan in the last warm step")
    if tuple(res.u.shape) != (B, H, 1) or tuple(res.x.shape) != (B, H, 2):
        raise RuntimeError(f"unexpected plan shapes {tuple(res.x.shape)}, "
                           f"{tuple(res.u.shape)}")

    # time split: stage blocks and sweeps timed alone at the same shapes,
    # times their call counts in the last warm step (one block
    # preparation per solver iteration of the lockstep batch)
    solver_rt = nempc.runtime(xs, params=params)
    solver_rt["_s_obj"] = torch.ones(B, device="cuda")
    direction = nempc.solve.riccati.make_riccati_direction(mpc.nlp,
                                                           mpc.config)
    prep_ms = cuda_median_ms(
        lambda: direction.prepare(carry.w, carry.lam, solver_rt), runs=5)
    args = sweep_case("delta0", 0, "cuda")
    sweep_ms = cuda_median_ms(lambda: rk.riccati_sweep_cuda(*args))
    n_prep = int(res.iterations.max())
    step_ms = statistics.median(times) * 1e3
    blocks_ms = prep_ms * n_prep
    sweeps_ms = sweep_ms * launches[-1]
    log(f"[{card}] warm re-plan split (last step, estimated): stage blocks "
        f"{blocks_ms:.1f} ms ({n_prep} x {prep_ms:.2f} ms), sweeps "
        f"{sweeps_ms:.2f} ms ({launches[-1]} x {sweep_ms:.4f} ms a wrapper "
        "call, host work included), rest "
        f"{step_ms - blocks_ms - sweeps_ms:.1f} ms of p50 {step_ms:.1f} ms")
    # device time of one more warm re-plan (same carry, result dropped),
    # from torch.profiler's kernel and copy events, over the unprofiled p50
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mpc.next_batch(xs, params=params, carry=carry)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if dev:
        dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        log(f"[{card}] one warm re-plan: {len(dev)} device events "
            f"(kernels and copies), {dev_ms:.1f} ms of device time -> device "
            f"busy {dev_ms / step_ms:.1%} of the p50 re-plan")
    else:
        log("device busy share: not measured (the trace holds no device "
            "events)")
    p50 = statistics.median(times)
    log(f"[{card}] warm re-plan B={B}: p50 {p50 * 1e3:.1f} ms, min "
        f"{min(times) * 1e3:.1f} ms -> {B / p50:,.0f} solves/s; converged "
        f"per step {conv}")
    return params, x0s, main_launches


def phase_card_vs_cpu(nempc, params, x0s):
    x0s = x0s[:N_CARD_VS_CPU]
    out = {}
    for dev in ("cuda", "cpu"):
        mpc = make_controller(nempc, dev)
        p_dev = [{k: v.to(dev) for k, v in layer.items()} for layer in params]
        _, res = mpc.next_batch(torch.as_tensor(x0s, device=dev),
                                params=p_dev)
        out[dev] = res
    du = float((out["cuda"].u.cpu() - out["cpu"].u).abs().max())
    same = bool(torch.equal(out["cuda"].converged.cpu(),
                            out["cpu"].converged))
    log(f"card vs CPU ({N_CARD_VS_CPU} cold solves): max |du| {du:.3e}, "
        f"converged masks equal: {same}")
    if not (du <= CARD_VS_CPU_DU and same):
        raise RuntimeError(f"card and CPU solves differ: |du| {du:.3e}, "
                           f"masks equal {same}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(1)
    import pyneuralempc_tpu_torch as nempc
    from pyneuralempc_tpu_torch.ops.cuda import build
    rk = nempc.riccati_kernel

    # phase 1: device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN (full f32)")

    # phase 2: build
    t0 = time.perf_counter()
    r = build.build(build.CSRC_DIR / rk.SOURCE)
    log(f"built {rk.SOURCE} -> {r.path.name} in {r.seconds:.1f} s")
    for line in r.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    log(f"build phase {time.perf_counter() - t0:.1f} s")

    # phase 3: kernel vs plain
    kernel = phase_kernels(rk)

    # phases 4, 6: main path and its numbers
    params, x0s, launches = phase_main_path(nempc, rk, card)
    kernel["launches"] = launches

    # phase 5: card vs CPU
    phase_card_vs_cpu(nempc, params, x0s)

    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
