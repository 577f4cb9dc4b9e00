"""``replan_mfu``: the traced re-plans' share of the card's float32 peak.

The work is a count from the configuration's widths, the same for every
version of the program: for each member's own iterations
(``IPResult.iterations`` summed over the members, so iterations that a
member runs only because the batch runs in lockstep count as lost), at
each of the H stages, 2 + 2·(nx + nu) model evaluations of
``stage_flops`` (the value, a trial point, and a forward and a reverse
pass for each of the nx + nu directions of the stage's Jacobian and the
Hessian of the defects) and one Riccati sweep stage
(``sweep_counts.sweep_flops``).  Residuals, restorations and the line
search's further trial points are not counted, so the share reads low.
The time is the device trace's: from the first device operation of the
traced re-plans to the end of the last (the device-alone trace), so idle
gaps between operations count as time."""

from benchmark.reference.sweep_counts import sweep_flops


def read(ctx):
    if ctx.trace is None or ctx.peaks is None or not ctx.trace.device_span_s:
        return None
    recs = ctx.records[: ctx.traced]
    evals = 2 + 2 * (ctx.nx + ctx.nu)
    per_it = ctx.H * evals * ctx.stage_flops \
        + sweep_flops(1, ctx.H, ctx.nx, ctx.nu)
    work = per_it * sum(r["it_sum"] for r in recs)
    return 100.0 * work / (ctx.trace.device_span_s * ctx.peaks["f32_flops"])
