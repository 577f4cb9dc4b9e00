"""Run one cell once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

The cell's configuration builds the port's controller (``NMPC``) and the
benchmark's plant and reference; its traffic mix (:mod:`.traffic`) drives
a fleet controller's closed loop through ``NMPC.next_batch``: one caller
waits for each re-plan before it sends the next, with no fixed rate.

* Set-up (``setup_s``, from the harness's first line to the first timed
  re-plan): imports, the kernels' builds (the first run in a checkout),
  the configuration's model (fitted by the first run, loaded after), the
  cold solve and the mix's ``lead_in`` warm re-plans.  They run the
  window's shapes, so nothing builds inside the window.
* The window: re-plans start while fewer than ``--seconds`` have passed
  since the first one began; each is timed on the host clock from the call
  until ``torch.cuda.synchronize()`` returns.  Between re-plans the plant
  takes the plan's first control and the mix's disturbance.
* ``--trace 1`` profiles the window's first ``trace_replans`` re-plans
  (:mod:`.trace`) and reports the per-layer metrics; ``--trace 0`` the
  end-to-end ones.  Each metric is read by its own reader,
  ``benchmark/metrics/<metric>.py``: ``read(ctx) -> float | None``.
* Once the window has closed: the peak of device memory, then the
  program's state is freed and the plain reference judges the sampled
  plans (:mod:`.check`).

Exit codes: 0 with a result line (``correct`` true or false); 2 without
the devices the cell asks for; 3 where the package under test is not in
the checkout; 4 where JAX or the JAX package was loaded; 5 where a metric
read is not finite.  Nothing is printed to standard output but the result
line.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check as check_mod
from . import env
from . import trace as trace_mod
from .layout import Layout
from .peaks import peaks_of
from .traffic import Traffic

PORT = "pyneuralempc_tpu_torch"
# whole top-level module names that may not be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "pyneuralempc_tpu")


class Refused(Exception):
    def __init__(self, code: int, why: str):
        super().__init__(why)
        self.code = code


@dataclasses.dataclass
class Context:
    """What a metric reader reads."""
    workload: str
    cfg: dict
    mix: dict
    B: int
    H: int
    nx: int
    nu: int
    stage_flops: int
    setup_s: float
    records: List[dict]           # one a window re-plan
    traced: int                   # re-plans in the device-alone trace
    trace: Optional[trace_mod.TraceSummary]
    counters_traced: Dict[str, int]
    families: list
    peaks: Optional[dict]


def forbidden_modules() -> List[str]:
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


def require_devices(chips: int):
    if not torch.cuda.is_available():
        raise Refused(2, "torch.cuda.is_available() is false: no card")
    if torch.cuda.device_count() < chips:
        raise Refused(2, f"{torch.cuda.device_count()} card(s), the cell "
                      f"asks for {chips}")


def import_port(root: Path):
    """The package under test, from the checkout at ``root`` only."""
    try:
        import pyneuralempc_tpu_torch as port
    except ImportError as e:
        raise Refused(3, f"{PORT} is not in the checkout: {e}")
    where = Path(port.__file__).resolve().parent.parent
    if where != root:
        raise Refused(3, f"{PORT} was loaded from {where}, not from the "
                      f"checkout {root}")
    return port


def port_counters(port) -> Dict[str, int]:
    """Every launch and call counter of the port's sweep modules."""
    out = {}
    for mod in (port.riccati_kernel, port.riccati_general):
        short = mod.__name__.rsplit(".", 1)[-1]
        for k, v in vars(mod).items():
            if k.isupper() and (k.endswith("LAUNCHES")
                                or k.endswith("CALLS")) \
                    and isinstance(v, int):
                out[f"{short}.{k}"] = v
    return out


def _merge(base: dict, over: Optional[dict]) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out


class Loop:
    """The closed loop: re-plans, the plant between them, the records."""

    def __init__(self, cell, traffic: Traffic, device):
        self.cell, self.traffic = cell, traffic
        self.cuda = torch.device(device).type == "cuda"
        self.x = traffic.x0
        self.carry = None
        self.samples = check_mod.Samples()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def step(self, k: int, record: bool) -> Optional[dict]:
        tr, cell = self.traffic, self.cell
        x0, tvp, p = tr.request(k)
        if x0 is not None:
            self.x, self.carry = x0, None
        carry_in = self.carry
        t0 = time.perf_counter()
        carry, res = cell.mpc.next_batch(self.x, p=p, tvp=tvp,
                                         params=cell.params, carry=carry_in)
        self.sync()
        t1 = time.perf_counter()
        rec = None
        if record:
            it = res.iterations
            rec = {"t0": t0, "t1": t1, "dt": t1 - t0,
                   "attempted": int(res.converged.numel()),
                   "converged": int(res.converged.sum()),
                   "it_max": int(it.max()), "it_sum": int(it.sum()),
                   "restorations": int(torch.as_tensor(res.restorations)
                                       .sum())}
            self.samples.add(tr.check_members(k), self.x, tvp, p, carry_in,
                             carry, res)
        self.x = cell.plant(self.x, res.u[:, 0]) + tr.disturbance(k)
        self.carry = carry
        return rec


def run(layout: Layout, workload: str, seed: int, seconds: float,
        trace: bool, *, t_start: float, device="cuda", control=False,
        overrides: Optional[dict] = None, wrap=None,
        port_root: Optional[Path] = None, detail: Optional[dict] = None,
        log=sys.stderr):
    """One run of ``workload``; returns the result dict (its last key
    ``checks``).  ``control`` builds the configuration's lower-precision
    control in the program's place; ``overrides`` (``{"config": {...},
    "traffic": {...}}``), ``wrap(cell)`` and ``port_root`` (where the
    package under test must lie; the checkout by default) serve the
    tests; ``detail``, a dict, receives every sampled member's readings
    (``per_member``) and the window's records."""
    entry = layout.workload(workload)
    _, cfg, builder = layout.config(entry["config"])
    mix = layout.traffic(entry["traffic"])
    cfg = _merge(cfg, (overrides or {}).get("config"))
    mix = _merge(mix, (overrides or {}).get("traffic"))
    dev = torch.device(device)
    if dev.type == "cuda":
        require_devices(int(entry["chips"]))
    port = import_port(Path(port_root or layout.root).resolve())
    cache = env.cache_dir(layout.root)
    port.enable_compilation_cache(str(cache / "nvcc"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phases = [("imports", time.perf_counter())]
    cell = builder.build(cfg, mix, device=dev, cache_dir=cache,
                         control=control)
    if wrap is not None:
        wrap(cell)
    traffic = Traffic(mix, cfg, seed, dev, lift=cell.lift)
    loop = Loop(cell, traffic, dev)
    phases.append(("model and inputs", time.perf_counter()))
    k = 0
    for k in range(1 + traffic.lead_in):
        loop.step(k, record=False)
        if k == 0:
            loop.sync()
            phases.append(("cold solve (kernel builds in a first run)",
                           time.perf_counter()))
    loop.sync()
    # what set-up made stays: the collector's passes in the window skip it
    gc.collect()
    gc.freeze()
    phases.append((f"{traffic.lead_in} lead-in re-plans", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    last = t_start
    for name, t in phases:
        print(f"set-up: {name} {t - last:.3f} s", file=log)
        last = t

    records, profs = [], {}
    n_trace = traffic.trace_replans if trace else 0
    counters0 = counters1 = port_counters(port)
    t_win = time.perf_counter()
    while True:
        k += 1
        n = len(records)
        if trace and n in (0, n_trace):
            # the first n_trace re-plans: device activity alone (the
            # metrics); the next n_trace: host ops too (the idle gaps)
            loop.sync()
            if n == 0:
                counters0 = port_counters(port)
            profs[n == n_trace] = _Traced(dev, host=n == n_trace)
        records.append(loop.step(k, record=True))
        if trace and n + 1 in (n_trace, 2 * n_trace):
            loop.sync()
            if n + 1 == n_trace:
                counters1 = port_counters(port)
            profs[n + 1 == 2 * n_trace].stop(log)
        if (time.perf_counter() - t_win >= seconds
                and len(records) >= 2 * n_trace):
            break
    loop.sync()
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    summary = gaps = None
    if trace:
        t_read = time.perf_counter()
        summary = profs[False].summary()
        gaps = profs[True].summary()
        print(f"traces read in {time.perf_counter() - t_read:.2f} s",
              file=log)
    profs = None

    # the program's state goes before the reference runs
    samples = loop.samples
    problem = cell.problem
    ctx = Context(
        workload=workload, cfg=cfg, mix=mix, B=traffic.B, H=cell.H,
        nx=cell.nx, nu=cell.nu, stage_flops=cell.stage_flops,
        setup_s=setup_s, records=records, traced=n_trace,
        trace=summary,
        counters_traced={k_: counters1[k_] - counters0[k_]
                         for k_ in counters0},
        families=layout.kernel_families(),
        peaks=peaks_of(torch.cuda.get_device_name(dev))
        if dev.type == "cuda" else None)
    del loop, cell, traffic
    gc.unfreeze()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    per_member = check_mod.residuals(problem, samples)
    checks, ok = check_mod.judge(per_member, cfg["check"]["limits"])
    if detail is not None:
        detail.update(per_member=per_member, records=records)

    metrics = {}
    for m in layout.metrics(workload, trace):
        value = layout.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": int(entry["chips"]) if dev.type == "cuda" else 1,
        "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(ok),
              "attempted": sum(r["attempted"] for r in records),
              "failed": sum(r["attempted"] - r["converged"] for r in records),
              "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
        result["breakdown"] = {
            "device_ops": [[n[:200], s] for n, s in summary.top_device_ops()],
            "idle_gaps": [[n[:200], s] for n, s in gaps.top_idle()]}
    result["checks"] = checks
    _report(log, dev, records, setup_s, summary, gaps, ctx)
    return result


class _Traced:
    """A profiler over the next re-plans: the device's activity alone, or
    with ``host`` every host op too, inside the span ``bench.window``."""

    def __init__(self, dev, host: bool):
        acts = ([torch.profiler.ProfilerActivity.CUDA]
                if dev.type == "cuda" else [])
        if host or not acts:
            acts.append(torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.span = torch.profiler.record_function(trace_mod.WINDOW_SPAN)
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, log):
        self.window_s = time.perf_counter() - self.t0
        self.span.__exit__(None, None, None)
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        print(f"profiler stopped in {time.perf_counter() - t:.2f} s",
              file=log)

    def summary(self) -> trace_mod.TraceSummary:
        return trace_mod.summarize(self.prof, self.window_s)


def _power(dev) -> str:
    if dev.type != "cuda":
        return "no card"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def _report(log, dev, records, setup_s, summary, gaps, ctx: Context):
    """The lines before the check lines: the card, the window's size and
    halves, the trace."""
    print(f"card: {_power(dev)}", file=log)
    dts = [r["dt"] for r in records]
    print(f"set-up {setup_s:.3f} s; window: {len(records)} re-plans of "
          f"{ctx.B} members, p50 {1e3 * float(np.median(dts)):.1f} ms, "
          f"p90 {1e3 * float(np.percentile(dts, 90)):.1f} ms "
          f"({len(dts)} samples)", file=log)
    h = len(records) // 2
    for name, part in (("first half", records[:h]),
                       ("second half", records[h:])):
        if part:
            print(f"{name}: {len(part)} re-plans, mean "
                  f"{1e3 * float(np.mean([r['dt'] for r in part])):.1f} "
                  f"ms, lockstep iterations mean "
                  f"{float(np.mean([r['it_max'] for r in part])):.2f}, "
                  f"converged {sum(r['converged'] for r in part)}/"
                  f"{sum(r['attempted'] for r in part)}", file=log)
    if summary is not None:
        for fam in ctx.families:
            pats = [re.compile(p) for p in fam.PATTERNS]
            seen = sum(c for n, c in summary.device_count.items()
                       if any(p.search(n) for p in pats))
            counted = {c: ctx.counters_traced.get(c, 0)
                       for c in fam.SWEEP_COUNTERS}
            print(f"kernel family {Path(fam.__file__).stem}: {seen} "
                  f"operations in the trace; its counters {counted}",
                  file=log)
        n = ctx.traced
        replans = ctx.records[n - 1]["t1"] - ctx.records[0]["t0"]
        counters = {k: v for k, v in ctx.counters_traced.items() if v}
        print(f"traced {n} re-plans, device activity alone: window "
              f"{summary.window_s:.4f} s ({replans:.4f} s of re-plans), "
              f"device busy {summary.busy_s:.4f} s in "
              f"{summary.device_events} operations; counters {counters}",
              file=log)
        print(f"traced {n} more re-plans with host ops: window "
              f"{gaps.window_s:.4f} s, device busy {gaps.busy_s:.4f} s",
              file=log)


def print_result(result: dict, out=sys.stdout, log=sys.stderr):
    """The check lines last on standard error, the result line last on
    standard output."""
    for name, c in result["checks"].items():
        if name == "compared":
            print(f"check compared {c['value']} (at least {c['limit']})",
                  file=log)
        else:
            print(f"check {name} {c['value']!r} (limit {c['limit']!r})",
                  file=log)
    log.flush()
    print(json.dumps(result), file=out)
    out.flush()


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, *, t_start: float, root: Path) -> int:
    args = parse(argv)
    torch.set_num_threads(2)
    try:
        result = run(Layout(root), args.workload, args.seed, args.seconds,
                     bool(args.trace), t_start=t_start)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return e.code
    found = forbidden_modules()
    if found:
        print(f"loaded where it may not be: {', '.join(found)}",
              file=sys.stderr)
        return 4
    if not all(math.isfinite(m["value"]) for m in result["metrics"].values()):
        print(f"a metric is not finite: {result['metrics']}", file=sys.stderr)
        return 5
    print_result(result)
    return 0
