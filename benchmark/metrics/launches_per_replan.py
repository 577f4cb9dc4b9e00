"""``launches_per_replan``: device operations (kernels, copies, sets) in
the traced re-plans' window, per traced re-plan, from the profiler's
trace."""


def read(ctx):
    if ctx.trace is None or not ctx.traced or not ctx.trace.device_events:
        return None
    return ctx.trace.device_events / ctx.traced
