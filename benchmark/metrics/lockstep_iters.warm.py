"""``lockstep_iters.warm``: the mean over the window's re-plans of the most
interior-point iterations any member took (``IPResult.iterations``): the
batch advances in lockstep until its slowest member is done, so this sets
a re-plan's cost."""


def read(ctx):
    if not ctx.records:
        return None
    return sum(r["it_max"] for r in ctx.records) / len(ctx.records)
