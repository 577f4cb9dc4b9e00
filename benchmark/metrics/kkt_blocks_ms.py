"""``kkt_blocks_ms``: device ms of the KKT blocks a traced re-plan: the
spans ``kkt.prepare`` (the Riccati stage blocks through the model, or the
dense backend's Hessian and Jacobian), in every iteration and the polish."""

from benchmark.metrics._spans import device_ms, window


def read(ctx):
    spans = window(ctx)
    if spans is None:
        return None
    return device_ms(spans, ("kkt.prepare",)) / ctx.traced
