"""The port's spans in the traced re-plans, for the span readers.

The port (``pyneuralempc_tpu_torch.utils.tracing``) records spans only
while a profiler records, and the harness profiles the window's first
``ctx.traced`` re-plans with the device's activity alone, then as many
more with host ops too.  So the last ``2 * ctx.traced`` roots it holds are
those re-plans' (counting from the end keeps an earlier run in the same
process out), and the readers take the spans under the first
``ctx.traced`` of them: the device-alone window, which
``launches_per_replan`` reads too.  Where the program has no tracing
module, or recorded too few roots, there is nothing to read: None.

A span's ``device_ms`` is the stream's timeline from the end of the work
queued before it to the end of its own last work (CUDA timing events), so
device idle while the host issued the span's work counts to the span.
"""

from typing import Iterable, List, Optional


def window(ctx) -> Optional[List]:
    """The spans of the device-alone traced re-plans, or None."""
    if not ctx.traced:
        return None
    try:
        from pyneuralempc_tpu_torch.utils import tracing
    except ImportError:
        return None
    spans = tracing.finished()
    roots = [s for s in spans if s.parent is None]
    if len(roots) < 2 * ctx.traced:
        return None
    mine = {s.request for s in roots[-2 * ctx.traced:][:ctx.traced]}
    return [s for s in spans if s.request in mine]


def device_ms(spans, names: Iterable[str]) -> float:
    names = set(names)
    return sum(s.device_ms for s in spans if s.name in names)


def count(spans, name: str) -> int:
    return sum(s.name == name for s in spans)


def per_iteration(ctx, name: str) -> Optional[float]:
    """Spans named ``name`` over the ``ip.iteration`` spans."""
    spans = window(ctx)
    its = count(spans, "ip.iteration") if spans is not None else 0
    return count(spans, name) / its if its else None
