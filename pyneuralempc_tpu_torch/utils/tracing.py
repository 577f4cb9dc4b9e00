"""Spans at the solver's layer boundaries, recorded while a profiler records.

``with span("kkt.prepare"):`` marks one piece of a re-plan.  Tracing is on
exactly while a ``torch.profiler`` records (the profiler sets
``torch.autograd.profiler._is_profiler_enabled`` on start, whatever its
activities): there is no other switch.  Off, :func:`span` returns one shared
object whose ``with`` does nothing, so a re-plan's few dozen spans cost
microseconds; ``record_function`` is never entered then.

On, a span records:

* its name, its id and its parent's (the innermost span open on the thread
  when it starts; ``None`` for a root);
* its request: a sequence number that a root takes and every span under it
  shares, so one re-plan's spans group together;
* its host start and end (``time.perf_counter_ns``);
* its device time: on CUDA a pair of timing events recorded on the current
  stream at entry and exit, so ``device_ms`` is the stream's timeline from
  the end of the work queued before the span to the end of the span's last
  work, idle time while the host issued that work included; elsewhere the
  host interval stands in;
* ``attrs``: the keywords the site passed (a root's batch size ``B``) or
  noted from inside the span (``kkt.prepare``'s tanh-layer kernel
  launches, ``k1_launches`` and ``k2_launches``).

It also enters ``torch.profiler.record_function(name)``, which puts the span
into the profiler's trace on the same clock as the device's operations.

Finished spans stay in memory, the newest :data:`CAPACITY` of them; older
ones are dropped and counted (:func:`dropped`).  :func:`finished` returns
them in the order they ended.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, Optional

import torch
from torch.autograd import profiler as _profiler

CAPACITY = 1 << 16

_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_finished: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0


class _Off:
    """The span of every site while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **attrs):
        pass


_OFF = _Off()


class Span:
    """One span; once finished, a record (see the module's docstring)."""

    __slots__ = ("name", "id", "parent", "request", "device", "attrs",
                 "t0_ns", "t1_ns", "device_ms", "_events", "_rf")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self.device, self.attrs = name, device, attrs
        self.parent = self.request = self.t0_ns = self.t1_ns = None
        self.device_ms: Optional[float] = None
        self._events = None

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6

    def note(self, **attrs):
        """Add ``attrs`` to the span's, from inside it (counts the site
        knows only once its work is issued)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            up = stack[-1]
            self.parent, self.request = up.id, up.request
            if self.device is None:
                self.device = up.device
        else:
            self.request = next(_requests)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self.device is not None and torch.device(self.device).type \
                == "cuda":
            stream = torch.cuda.current_stream(self.device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(stream)
        stack.append(self)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        self.t1_ns = time.perf_counter_ns()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self.device))
        else:
            self.device_ms = self.host_ms
        _stack().pop()
        self._rf.__exit__(*exc)
        self._rf = None
        with _lock:
            if len(_finished) == CAPACITY:
                _dropped += 1
            _finished.append(self)
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, device=None, **attrs):
    """A span named ``name`` while a profiler records, else the shared
    no-op.  ``device``: where its work runs; None takes the enclosing
    span's (a root without one times on the host)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return Span(name, device, attrs)


def read_bool(name: str, flag: torch.Tensor) -> bool:
    """``bool(flag)``, the host's wait for it inside the span ``name``."""
    with span(name):
        return bool(flag)


def finished() -> List[Span]:
    """The finished spans kept, oldest first, each with ``device_ms``: a
    CUDA span's events are read here, once the device has run past them."""
    with _lock:
        spans = list(_finished)
    for s in spans:
        if s._events is not None:
            s._events[1].synchronize()
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            s._events = None
    return spans


def dropped() -> int:
    """Finished spans dropped to keep the newest :data:`CAPACITY`."""
    return _dropped
