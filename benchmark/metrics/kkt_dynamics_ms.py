"""``kkt_dynamics_ms``: device ms of the model's stage blocks a traced
re-plan: the spans ``kkt.dynamics`` inside ``kkt.prepare`` (A and B at
every stage by jacfwd of the model, and under the exact Hessian the defect
curvature G by jacfwd over its vjp; under a Gauss-Newton or objective
Hessian G is zeros and the span holds the jacfwd alone), in every
iteration and the polish.  None where the program records no such
span."""

from benchmark.metrics._spans import count, device_ms, window

SPAN = "kkt.dynamics"


def read(ctx):
    spans = window(ctx)
    if spans is None or not count(spans, SPAN):
        return None
    return device_ms(spans, (SPAN,)) / ctx.traced
