"""``kkt_solve_ms``: device ms of the KKT solves a traced re-plan: the
spans ``kkt.solve`` (Σ folded in, the right-hand side, every δ level's
sweep and the step's recovery), the Mehrotra predictor's, the line
search's second-order correction's and the polish's included."""

from benchmark.metrics._spans import device_ms, window


def read(ctx):
    spans = window(ctx)
    if spans is None:
        return None
    return device_ms(spans, ("kkt.solve",)) / ctx.traced
