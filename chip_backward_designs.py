"""Design turns of the streamed plain backward instance at one stage, on
one CUDA card: the wide fleet's (12, 10), H=50 (the default), or the LSTM
fleet's (18, 1), H=100; B=4096 at both.

Builds csrc/riccati_streamed.cu once as it is and once for each other
design of `riccati_general_backward_fixed<NX, NU, 1, 0>` at the stage,
each made from the committed sources by text edits of
csrc/riccati_backward_fixed.cuh (one each but where named), written with
the other headers into `pyneuralempc_tpu_torch/_build/designs/<name>/`.
At (12, 10):

* ``two buffers``: two stage buffers a warp (5 blocks an SM, B=4096 in
  two waves);
* ``7-block cap``: the register cap set for 7 blocks an SM (72 registers,
  two waves);
* ``lane kept``: the lane id read once, not anew each stage;
* ``triangles unfolded``: G's and M's upper triangles copied over the
  whole square, as the narrower instances copy them;
* ``Z rolled``: a Z lane's two columns rolled into a loop (the committed
  loop is unrolled, so that the narrower instances compile as they did).

At (18, 1), where two lanes a row of Y and of [P_new | p^T] would take 36
lanes, the committed instance spreads (row, float4 column) tiles 3 a lane
over 30 lanes (``FixedLayout::kTiles``); against it:

* ``one lane a row``: 18 lanes, each a row's 5 float4 columns, the row of
  Pbar (or A's column) in registers;
* ``7-block cap`` as above, and ``one lane a row, 7-block cap`` (two
  edits);
* ``lane kept`` and ``triangles unfolded`` as above.

Each design's gains and ok flags are held against `riccati_backward_plain`
on the four seeded cases (drawn at B=1024, repeated to 4096) within
2e-4 x max(1, |plain|); then all of them, with the run-time kernel, are
timed in turns a, b, ..., b, a, warm and with the L2 flushed (256 MB
written before each launch): CUDA events around each launch, every launch
queued behind a `torch.cuda._sleep` spin so that the host's pace does not
count.  Prints each design's ptxas report, one line a turn, the card's
name and power limit, and a JSON object of the turns last.

Run: python3 chip_backward_designs.py [NX NU]   (exits 1 without a CUDA
device; NX NU one of the stages above, 12 10 if not given)
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time

import torch

B, CASE_B = 4096, 1024
TOL = 2e-4
RUNS = 15
FLUSH_BYTES = 256 * 2 ** 20
SPIN_CYCLES = 60_000_000      # tens of ms: every launch of a turn queued
KINDS = ("delta0", "delta_per_problem", "negative_curvature", "local_bump")
HEADER = "riccati_backward_fixed.cuh"
HORIZON = {(12, 10): 50, (18, 1): 100}
# the text edits of HEADER that the designs share
TWO_BUFFERS = (
    "static constexpr int kBuffers = smem_fits(2 * kStagePad + kScratch) "
    "? 2 : 1;", "static constexpr int kBuffers = 2;")
CAP_7 = ("__launch_bounds__(kMaxWarps * 32, kMinBlocks)\n"
         "riccati_general_backward_fixed(",
         "__launch_bounds__(kMaxWarps * 32, 7)\n"
         "riccati_general_backward_fixed(")
LANE_KEPT = ("const int lane = L::kLarge ? lane_id() : lane0;",
             "const int lane = lane0;")
UNFOLDED = ("  if constexpr (L::kLarge) {\n#pragma unroll\n"
            "    for (int q = 0; q < (L::NT + 31) / 32;",
            "  if constexpr (false) {\n#pragma unroll\n"
            "    for (int q = 0; q < (L::NT + 31) / 32;")
ROW_LANES = ("static constexpr bool kTiles = kTall;",
             "static constexpr bool kTiles = false;")
# stage -> name -> the text edits of HEADER that make the design (None:
# the committed header)
DESIGNS = {
    (12, 10): {
        "instance": None,
        "two buffers": (TWO_BUFFERS,),
        "7-block cap": (CAP_7,),
        "lane kept": (LANE_KEPT,),
        "triangles unfolded": (UNFOLDED,),
        "Z rolled": (("#pragma unroll\n        for (int o = 0; o < L::ZC; "
                      "++o) {", "#pragma unroll 1\n        for (int o = 0; "
                      "o < L::ZC; ++o) {"),),
    },
    (18, 1): {
        "instance": None,
        "one lane a row": (ROW_LANES,),
        "7-block cap": (CAP_7,),
        "one lane a row, 7-block cap": (ROW_LANES, CAP_7),
        "lane kept": (LANE_KEPT,),
        "triangles unfolded": (UNFOLDED,),
    },
}


def log(msg):
    print(msg, flush=True)


def design_source(build, rk, stage, name, edits):
    """riccati_streamed.cu and the headers in a directory of their own, the
    backward header edited; the flag that names the design carries a hash
    of the edited header, so its library is never mistaken for another."""
    d = build.BUILD_DIR / "designs" / "{}x{}_{}".format(
        *stage, name.replace(" ", "_").replace(",", ""))
    d.mkdir(parents=True, exist_ok=True)
    for f in build.CSRC_DIR.glob("*.cuh"):
        text = f.read_text()
        if f.name == HEADER:
            for old, new in edits:
                if text.count(old) != 1:
                    raise RuntimeError(f"{HEADER} does not hold the text "
                                       f"that the design '{name}' edits")
                text = text.replace(old, new)
        (d / f.name).write_text(text)
    src = d / rk.STREAMED_SOURCE
    src.write_text((build.CSRC_DIR / rk.STREAMED_SOURCE).read_text())
    tag = hashlib.sha256((d / HEADER).read_bytes()).hexdigest()[:12]
    return src, (f"-DRICCATI_DESIGN_{tag}",)


def library_backward(path, rk, nx, nu, H):
    fn = ctypes.CDLL(str(path)).riccati_backward_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(*a):
        gains = torch.empty((B, H, rk.gain_width(nx, nu)), device="cuda")
        ok = torch.empty((B,), dtype=torch.bool, device="cuda")
        err = fn(*[t.data_ptr() for t in a], gains.data_ptr(), ok.data_ptr(),
                 B, H, nx, nu, 0, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return gains, ok
    return call


def ptxas(log_text, mangled):
    out, inside = [], False
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            inside = mangled in line
            continue
        if inside and ("Used" in line or "spill" in line):
            out.append(" ".join(line.replace("ptxas info    :", "").split()))
    return "; ".join(out)


def case(kind, seed, nx, nu, H):
    from pyneuralempc_tpu_torch.ops.cuda.sweep_cases import sweep_case
    args = [torch.as_tensor(a, device="cuda")
            for a in sweep_case(kind, B=CASE_B, H=H, nx=nx, nu=nu, seed=seed)]
    return [a.repeat((B // CASE_B,) + (1,) * (a.dim() - 1)) for a in args]


def turn_ms(fn, flush):
    """Median device time of RUNS launches, each between CUDA events, all
    queued behind one spin (and each after an L2 flush where given)."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(RUNS)]
    torch.cuda._sleep(SPIN_CYCLES)
    for e0, e1 in ev:
        if flush is not None:
            flush.zero_()
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    return statistics.median(e0.elapsed_time(e1) for e0, e1 in ev)


def main(argv):
    stage = tuple(map(int, argv)) if argv else (12, 10)
    if stage not in DESIGNS:
        print(f"chip_backward_designs: stage {stage} is none of "
              f"{sorted(DESIGNS)}", file=sys.stderr)
        sys.exit(2)
    if not torch.cuda.is_available():
        print("chip_backward_designs: no CUDA device; this script runs on "
              "the card", file=sys.stderr)
        sys.exit(1)
    from pyneuralempc_tpu_torch.ops.cuda import build
    from pyneuralempc_tpu_torch.ops.cuda import riccati_kernel as rk
    nx, nu = stage
    H, designs = HORIZON[stage], DESIGNS[stage]
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    log(f"card: {card}; stage ({nx}, {nu}), H={H}, B={B}")
    t0 = time.perf_counter()
    items = []
    for name, edits in designs.items():
        if edits is None:
            items.append(build.CSRC_DIR / rk.STREAMED_SOURCE)
            continue
        items.append(design_source(build, rk, stage, name, edits))
    built = build.build_all(items)
    log(f"built {len(built)} designs in {time.perf_counter() - t0:.1f} s")
    mangled = f"riccati_general_backward_fixedILi{nx}ELi{nu}ELi1ELi0EE"
    calls, reports = {}, {}
    for name, r in zip(designs, built):
        calls[name] = library_backward(r.path, rk, nx, nu, H)
        reports[name] = ptxas(r.log, mangled) or "built earlier"
        log(f"ptxas {name}: {reports[name]}")
    calls["run-time"] = lambda *a: rk.riccati_backward_runtime_cuda(*a)

    worst = {name: 0.0 for name in calls}
    for seed, kind in enumerate(KINDS):
        args = case(kind, seed, nx, nu, H)
        g_ref, ok_ref = rk.riccati_backward_plain(*args)
        for name, fn in calls.items():
            gains, ok = fn(*args)
            torch.cuda.synchronize()
            if not torch.equal(ok, ok_ref):
                raise RuntimeError(f"{kind}: {name}'s ok flags differ from "
                                   "the plain backward's")
            err = float(((gains - g_ref).abs()
                         / g_ref.abs().clamp(min=1.0))[ok_ref].max())
            if not err <= TOL:
                raise RuntimeError(f"{kind}: {name} differs from the plain "
                                   f"backward by {err:.3e} > {TOL}")
            worst[name] = max(worst[name], err)
        del args, g_ref
        torch.cuda.empty_cache()
    log("every design's ok flags equal the plain backward's; max scaled "
        "error " + ", ".join(f"{n} {e:.2e}" for n, e in worst.items()))

    args = case("delta0", 0, nx, nu, H)
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    order = tuple(calls) + tuple(reversed(tuple(calls)))
    turns = {}
    for cache, fl in (("warm", None), ("flushed", flush)):
        for name in order:
            ms = turn_ms(lambda: calls[name](*args), fl)
            turns.setdefault(f"{cache}, {name}", []).append(ms)
            log(f"turn [{cache}] {name}: {ms * 1e3:.2f} us")
    bound_ms = rk.backward_bytes(B, H, nx, nu) / 3.35e12 * 1e3
    mean = {k: statistics.mean(v) for k, v in turns.items()}
    for name in calls:
        log(f"{name}: {mean['warm, ' + name] * 1e3:.2f} us warm, "
            f"{mean['flushed, ' + name] * 1e3:.2f} us L2 flushed (means of "
            f"two turns): {bound_ms / mean['warm, ' + name]:.1%} of the "
            f"{bound_ms * 1e3:.2f} us bound")
    print(card)
    print(json.dumps({"card": card, "shape": [B, H, nx, nu],
                      "bound_ms": bound_ms, "turns_ms": turns,
                      "ptxas": reports, "max_scaled_err": worst}))


if __name__ == "__main__":
    main(sys.argv[1:])
