"""``host_sync_wait_pct``: the share of the traced re-plans' host time that
the host spends blocked on the device: the host time of the spans
``sync.live`` (each lockstep iteration's exit test), ``sync.ls`` (each
line-search pass's) and ``sync.ladder`` (each δ level's), over that of
the re-plans' roots.  Low: the host, not the device, sets the pace."""

from benchmark.metrics._spans import window


def read(ctx):
    spans = window(ctx)
    if spans is None:
        return None
    roots = sum(s.host_ms for s in spans if s.parent is None)
    waits = sum(s.host_ms for s in spans if s.name.startswith("sync."))
    return 100.0 * waits / roots if roots else None
