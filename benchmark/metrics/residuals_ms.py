"""``residuals_ms``: device ms of the residuals a traced re-plan: the spans
``ip.residuals`` (each iteration's end-of-step gradient, constraints and
vjps, and its KKT error) and ``ip.init`` (the objective's scaling gradient
and the starting point's residuals)."""

from benchmark.metrics._spans import device_ms, window


def read(ctx):
    spans = window(ctx)
    if spans is None:
        return None
    return device_ms(spans, ("ip.residuals", "ip.init")) / ctx.traced
