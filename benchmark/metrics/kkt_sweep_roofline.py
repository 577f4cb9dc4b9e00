"""``kkt_sweep_roofline``: the KKT sweep kernels' share of their roofline
in the traced re-plans.

The least time of one sweep at the cell's (B, H, nx, nu) is the larger of
its bytes over the card's bandwidth and its operations over its float32
rate (``benchmark/reference/sweep_counts.py``: inputs read once, outputs
written once, no gains between the passes).  That time, times the sweeps
the port's counters report (the counters each kernel family names), over
the summed device time of the kernels the families name
(``benchmark/kernels/*.py`` whose ``METRICS`` hold this metric)."""

from benchmark.harness.layout import family_patterns
from benchmark.reference.sweep_counts import least_seconds

METRIC = "kkt_sweep_roofline"


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    fams = [f for f in ctx.families if METRIC in f.METRICS]
    pats = family_patterns(fams, METRIC)
    busy = sum(s for name, s in ctx.trace.device_time.items()
               if any(p.search(name) for p in pats))
    counters = {c for f in fams for c in f.SWEEP_COUNTERS}
    sweeps = sum(ctx.counters_traced.get(c, 0) for c in counters)
    if not busy or not sweeps:
        return None
    least = least_seconds(ctx.B, ctx.H, ctx.nx, ctx.nu,
                          ctx.peaks["f32_flops"], ctx.peaks["bytes_per_s"])
    return 100.0 * sweeps * least / busy
