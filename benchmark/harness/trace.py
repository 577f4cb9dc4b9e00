"""Reading a ``torch.profiler`` trace of part of the window.

The harness profiles the window's first re-plans (the mix's
``trace_replans``) twice over: the device's activity alone, which costs
the host little, for the metrics; then as many more with every host op
too, inside one ``record_function`` span, ``bench.window``, whose start
and end bound that window in the profiler's clock, for what the host was
doing while the device idled.  From a trace's events it keeps:

* every device operation (kernels, copies, sets) inside the window: its
  count, and its time summed by name;
* ``busy_s``: the union of the device operations' intervals, clipped to
  the window; ``window_s``: the window's length; ``device_span_s``: from
  the first device operation's start to the last one's end;
* the idle gaps (the window less the busy union), each charged to the
  innermost host operation (an ATen op or a harness span) of the window's
  thread under way at the gap's middle: the idle seconds summed by that
  name.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple

WINDOW_SPAN = "bench.window"
HOST_OP, DEVICE_OP, OTHER = "host_op", "device_op", "other"


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_span_s: float
    device_events: int
    device_time: Dict[str, float]      # seconds a device op name, summed
    device_count: Dict[str, int]       # operations a device op name
    idle_by_host: Dict[str, float]     # idle seconds by host op name

    def top_device_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.device_time.items(), key=lambda kv: -kv[1])[:n]

    def top_idle(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]


def _kind(e, device: bool) -> str:
    """A device operation (kernel, copy, set), a host operation (an ATen op
    or a harness span), or neither (a CUDA runtime call on the host, the
    device-side span of a host annotation)."""
    name = e.name()
    if hasattr(e, "activity_type"):          # torch >= 2.12
        kind = e.activity_type()
        if kind in ("kernel", "gpu_memcpy", "gpu_memset"):
            return DEVICE_OP
        return HOST_OP if kind in ("cpu_op", "user_annotation") else OTHER
    annotation = bool(getattr(e, "is_user_annotation", lambda: False)())
    if device:
        return OTHER if annotation or name == WINDOW_SPAN else DEVICE_OP
    if name.startswith("cuda") or name.startswith("cu") and \
            name[2:3].isupper():
        return OTHER
    return HOST_OP


def _events(prof):
    """(name, is_device, kind, start_ns, end_ns, thread) of every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).endswith("CUDA")
        s = e.start_ns()
        out.append((e.name(), dev, _kind(e, dev), s, s + e.duration_ns(),
                    e.start_thread_id()))
    return out


def summarize(prof, window_s: float) -> TraceSummary:
    """The trace of ``prof``.  With host ops recorded, the window is the
    ``bench.window`` span's; a trace of the device's activity alone holds
    no host span, and every device operation in it belongs to the window,
    whose length ``window_s`` the host clock read."""
    events = _events(prof)
    spans = [e for e in events if e[0] == WINDOW_SPAN and not e[1]]
    dev_all = [(s, t, n) for n, d, k, s, t, _ in events
               if d and k == DEVICE_OP]
    if spans:
        w0, w1, tid = spans[0][3], spans[0][4], spans[0][5]
        window_s = (w1 - w0) * 1e-9
    else:
        tid = None
        w0 = min((s for s, _, _ in dev_all), default=0)
        w1 = w0 + int(window_s * 1e9)
    dev = sorted((max(s, w0), min(t, w1), n) for s, t, n in dev_all
                 if t > w0 and s < w1)
    device_time = collections.defaultdict(float)
    device_count = collections.Counter()
    for s, t, n in dev:
        device_time[n] += (t - s) * 1e-9
        device_count[n] += 1
    # the busy union and the gaps between its intervals
    busy, gaps, cur_s, cur_t = 0, [], None, None
    for s, t, _ in dev:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
                gaps.append((cur_t, s))
            else:
                gaps.append((w0, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is None:
        gaps.append((w0, w1))
    else:
        busy += cur_t - cur_s
        gaps.append((cur_t, w1))
    host = sorted((s, t, n) for n, d, k, s, t, th in events
                  if not d and th == tid and k == HOST_OP
                  and n != WINDOW_SPAN and t > w0 and s < w1)
    span = max((t for _, t, _ in dev), default=0) - dev[0][0] if dev else 0
    return TraceSummary(window_s=window_s, busy_s=busy * 1e-9,
                        device_span_s=span * 1e-9,
                        device_events=len(dev),
                        device_time=dict(device_time),
                        device_count=dict(device_count),
                        idle_by_host=_charge_gaps(gaps, host) if spans
                        else {})


def _charge_gaps(gaps, host) -> Dict[str, float]:
    """Idle seconds by the innermost host op open at each gap's middle
    (host ops of one thread nest, so a stack sweep finds it)."""
    idle = collections.defaultdict(float)
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps if b > a)
    stack, i = [], 0
    for m, length in mids:
        while i < len(host) and host[i][0] <= m:
            s, t, n = host[i]
            while stack and stack[-1][1] <= s:
                stack.pop()
            stack.append((s, t, n))
            i += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        inner = next((n for s, t, n in reversed(stack) if t >= m), None)
        idle[inner or "(Python between host ops)"] += length * 1e-9
    return dict(idle)
