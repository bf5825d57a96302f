"""Lightweight spans exported as Chrome/Perfetto trace-event JSON.  A copy
of ``repro/obs/trace.py`` (which imports no JAX): the same span names and
the same trace JSON.

One request's life — batcher enqueue → coalesce → fold-in → deliver, or an
online ingest → drift decision → publish → swap — becomes one readable
trace:

    tracer = Tracer()
    with tracer.span("fold_in", batch=64):
        with tracer.span("mm"):
            ...
    tracer.export("trace.json")        # load in ui.perfetto.dev

Spans are "X" (complete) events in the Chrome trace-event format: name,
microsecond start/duration, thread id, and arbitrary ``args``.  Nesting is
positional — Perfetto stacks spans on the same thread by containment, so a
``with`` inside a ``with`` renders as a child without any bookkeeping here
beyond per-thread timing.

The serve/online layers emit spans through the PROCESS-DEFAULT tracer
(``default_tracer()``), which starts disabled: ``span()`` on a disabled
tracer is a shared no-op context manager, so instrumented hot paths cost
one attribute check when nobody is tracing.  ``default_tracer().enable()``
(or constructing your own ``Tracer`` and passing it where accepted) turns
collection on.  The event buffer is bounded (``max_events``); overflow
drops new events and counts them in ``dropped`` rather than growing
without limit under live traffic.
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass


@dataclass(frozen=True)
class SpanEvent:
    """One completed span (times in microseconds since the tracer epoch)."""
    name: str
    ts_us: float
    dur_us: float
    tid: int
    args: tuple = ()

    def to_chrome(self, pid: int = 1) -> dict:
        return {"name": self.name, "ph": "X", "ts": self.ts_us,
                "dur": self.dur_us, "pid": pid, "tid": self.tid,
                "args": dict(self.args)}


class _NullSpan:
    """Shared do-nothing context manager for disabled tracers."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects spans from any thread; exports one Chrome trace JSON."""

    def __init__(self, *, enabled: bool = True, max_events: int = 100_000):
        self._lock = threading.Lock()
        self._events: list[SpanEvent] = []
        self._epoch = time.perf_counter()
        self.enabled = enabled
        self.max_events = int(max_events)
        self.dropped = 0

    # -- collection ---------------------------------------------------------

    def enable(self) -> "Tracer":
        self.enabled = True
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    @contextmanager
    def _span_cm(self, name: str, args: tuple):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            t1 = time.perf_counter()
            self.record(name, t0, t1, args)

    def span(self, name: str, **args):
        """Context manager timing one span; ``args`` land in the trace
        viewer's detail pane.  No-op (and allocation-free) when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return self._span_cm(name, tuple(sorted(args.items())))

    def record(self, name: str, t0: float, t1: float,
               args: tuple = ()) -> None:
        """Append one completed span from raw perf_counter endpoints."""
        if not self.enabled:
            return
        ev = SpanEvent(name=name, ts_us=(t0 - self._epoch) * 1e6,
                       dur_us=(t1 - t0) * 1e6,
                       tid=threading.get_ident() % 2**31, args=args)
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    # -- introspection / export ---------------------------------------------

    def spans(self) -> list[SpanEvent]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def export(self, path: str) -> str:
        """Write ``{"traceEvents": [...]}`` JSON loadable by Perfetto /
        chrome://tracing; returns the path."""
        evs = sorted(self.spans(), key=lambda e: e.ts_us)
        doc = {"traceEvents": [e.to_chrome() for e in evs],
               "displayTimeUnit": "ms",
               "otherData": {"dropped_events": self.dropped}}
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


_DEFAULT = Tracer(enabled=False)


def default_tracer() -> Tracer:
    """The process-default tracer the serve/online instrumentation points
    emit into.  Disabled (free) until ``default_tracer().enable()``."""
    return _DEFAULT


def span(name: str, **args):
    """``with span("fold_in", batch=b):`` against the default tracer."""
    return _DEFAULT.span(name, **args)
