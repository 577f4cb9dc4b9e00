"""``solves_per_s``: the members whose re-plan converged, over the window's
whole time, from the first re-plan's call to the end of the last one (the
plant steps between them included)."""


def read(ctx):
    if not ctx.records:
        return None
    span = ctx.records[-1]["t1"] - ctx.records[0]["t0"]
    return sum(r["converged"] for r in ctx.records) / span
