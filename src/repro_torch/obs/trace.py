"""Lightweight spans exported as Chrome/Perfetto trace-event JSON.  The
host spans are a copy of ``repro/obs/trace.py`` (which imports no JAX):
the same span names and the same trace JSON.  Device spans are the port's
own.

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

Device spans (``device_span``) time work queued on a CUDA stream: a pair
of ``torch.cuda.Event``s recorded on the current stream at enter and at
exit, read by ``resolve()`` once they have completed, never by a
synchronisation of their own.  The engine resolves at the read-back each
segment already makes.  A resolved device span lies on a track of its own
per device, its duration the events' elapsed time.  Its start is placed
by its offset from the batch's first event, anchored at that event's host
record time, and its ``host_dur_us`` arg is the enqueue time of its
``with`` block.  A device span opened inside another one of the same
tracer, on the same thread, carries the outer span's args beside its own.
On a CPU device the work is synchronous and a device span is a host span.

While ``torch.profiler`` records, the spans of an enabled tracer also
enter ``torch.profiler.record_function``: each shows in the profiler's
trace as a ``user_annotation`` range around its operators and launches,
on the profiler's clock.  A disabled tracer puts nothing there.

The port's iteration loops record into the ACTIVE tracer
(``active_tracer()``): the process default, unless ``use_tracer`` installed
another for the current thread (``NMFSolver.fit(tracer=...)`` does).
"""

from __future__ import annotations

import json
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass

import torch

#: tid of device ``i``'s track in the export (host tids are below 2**31)
DEVICE_TRACK = 2**31


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


def _faking() -> bool:
    """Whether a ``FakeTensorMode`` is active (``lower_step``, the dry
    run): its tensors hold no data and no work reaches a device."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _annotation(name: str):
    """The profiler's range for a span while ``torch.profiler`` records."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return nullcontext()


@dataclass
class _Pending:
    """A device span whose events have been recorded, not yet read."""
    name: str
    start: object           # torch.cuda.Event
    end: object
    t0: float               # perf_counter at enter and at exit
    t1: float
    track: int
    args: tuple


class Tracer:
    """Collects spans from any thread; exports one Chrome trace JSON."""

    def __init__(self, *, enabled: bool = True, max_events: int = 100_000):
        self._lock = threading.Lock()
        self._events: list[SpanEvent] = []
        self._pending: list[_Pending] = []
        self._open = threading.local()        # args of open device spans
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
        with _annotation(name):
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

    def device_span(self, name: str, device, **args):
        """Context manager timing the device work queued inside it on
        ``device`` (a ``torch.device``): CUDA events on the current stream,
        read by ``resolve()``; a host span on the CPU; nothing under a
        ``FakeTensorMode``.  No-op (and allocation-free) when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return self._device_cm(name, device, args)

    @contextmanager
    def _device_cm(self, name: str, device, args: dict):
        if _faking():
            yield self
            return
        stack = self._open.__dict__.setdefault("stack", [])
        merged = tuple(sorted({**dict(stack[-1] if stack else ()),
                               **args}.items()))
        stack.append(merged)
        try:
            if device.type != "cuda":
                with self._span_cm(name, merged):
                    yield self
                return
            with _annotation(name):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                try:
                    yield self
                finally:
                    end.record()
                    t1 = time.perf_counter()
                    track = DEVICE_TRACK + (device.index or 0)
                    self._keep(self._pending, _Pending(name, start, end, t0,
                                                       t1, track, merged))
        finally:
            stack.pop()

    def _keep(self, into: list, item) -> None:
        """Append to ``into`` (spans or pending device spans) unless the
        buffer is full."""
        with self._lock:
            if len(self._events) + len(self._pending) >= self.max_events:
                self.dropped += 1
                return
            into.append(item)

    def resolve(self) -> int:
        """Turn every pending device span whose events have completed into
        a span (in the order they closed, up to the first still running);
        returns how many.  Never waits on the device."""
        with self._lock:
            done = 0
            for p in self._pending:
                if not p.end.query():
                    break
                done += 1
            batch = self._pending[:done]
            del self._pending[:done]
        if not batch:
            return 0
        anchor = min(batch, key=lambda p: p.t0)
        ts0, first = (anchor.t0 - self._epoch) * 1e6, anchor.start
        evs = [SpanEvent(name=p.name,
                         ts_us=ts0 + 1e3 * first.elapsed_time(p.start),
                         dur_us=1e3 * p.start.elapsed_time(p.end),
                         tid=p.track,
                         args=p.args + (("host_dur_us",
                                         (p.t1 - p.t0) * 1e6),))
               for p in batch]
        with self._lock:
            self._events.extend(evs)
        return len(evs)

    def record(self, name: str, t0: float, t1: float,
               args: tuple = ()) -> None:
        """Append one completed span from raw perf_counter endpoints."""
        if not self.enabled:
            return
        self._keep(self._events,
                   SpanEvent(name=name, ts_us=(t0 - self._epoch) * 1e6,
                             dur_us=(t1 - t0) * 1e6,
                             tid=threading.get_ident() % 2**31, args=args))

    # -- introspection / export ---------------------------------------------

    def spans(self) -> list[SpanEvent]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._pending.clear()
            self.dropped = 0

    def export(self, path: str) -> str:
        """Write ``{"traceEvents": [...]}`` JSON loadable by Perfetto /
        chrome://tracing, the device spans resolved so far included (each
        device's track named by a metadata event); returns the path."""
        self.resolve()
        evs = sorted(self.spans(), key=lambda e: e.ts_us)
        tracks = sorted({e.tid for e in evs if e.tid >= DEVICE_TRACK})
        names = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": t,
                  "args": {"name": f"cuda:{t - DEVICE_TRACK}"}}
                 for t in tracks]
        doc = {"traceEvents": names + [e.to_chrome() for e in evs],
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


_ACTIVE = threading.local()


def active_tracer() -> Tracer:
    """The tracer the port's iteration loops record into on this thread:
    the one ``use_tracer`` installed, else the process default."""
    return getattr(_ACTIVE, "tracer", None) or _DEFAULT


@contextmanager
def use_tracer(tracer: Tracer):
    """Make ``tracer`` the active tracer of this thread while open."""
    prev = getattr(_ACTIVE, "tracer", None)
    _ACTIVE.tracer = tracer
    try:
        yield tracer
    finally:
        _ACTIVE.tracer = prev
