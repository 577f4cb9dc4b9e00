"""``line_search_ms``: device ms of the merit line search a traced re-plan:
the spans ``ip.line_search`` (the merit at the current point, every trial
point's constraints and barrier value, the host's read of each pass) less
the second-order correction's ``kkt.solve`` inside them, which
``kkt_solve_ms`` counts."""

from benchmark.metrics._spans import window


def read(ctx):
    spans = window(ctx)
    if spans is None:
        return None
    soc = {}
    for s in spans:
        if s.name == "kkt.solve":
            soc[s.parent] = soc.get(s.parent, 0.0) + s.device_ms
    return sum(s.device_ms - soc.get(s.id, 0.0) for s in spans
               if s.name == "ip.line_search") / ctx.traced
