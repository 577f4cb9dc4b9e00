"""``kkt_cost_ms``: device ms of the cost's stage blocks a traced re-plan:
the spans ``kkt.cost`` inside ``kkt.prepare`` (the stage and terminal
costs' Hessians, or a separable objective's blocks, times the objective's
scale), in every iteration and the polish.  None where the program records
no such span."""

from benchmark.metrics._spans import count, device_ms, window

SPAN = "kkt.cost"


def read(ctx):
    spans = window(ctx)
    if spans is None or not count(spans, SPAN):
        return None
    return device_ms(spans, (SPAN,)) / ctx.traced
