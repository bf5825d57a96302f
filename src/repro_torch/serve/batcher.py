"""Microbatching front-end: coalesce concurrent fold-in requests.
Counterpart of ``repro/serve/batcher.py``.

Single-row projection wastes the accelerator — the batched NNLS solve in
``serve/foldin.py`` amortises the Gram solve and the jit dispatch over the
whole batch (single-device or mesh-sharded alike: the batcher only sees a
``project`` callable, so a sharded projector drops in unchanged;
``repro_torch.serve.mesh.MeshServer`` drives one).  ``MicroBatcher``
is the piece that turns independent callers into batches: a thread-safe
queue plus one worker thread that drains up to ``max_batch`` requests or
until ``max_delay_s`` after the first queued request (whichever comes
first), runs the batch through one ``project`` call, and resolves each
caller's ``Future`` with its own row of the result.

The deadline starts at the FIRST request of a batch, so an isolated request
pays at most ``max_delay_s`` extra latency while a burst fills the batch
immediately — the standard latency/throughput knob pair of serving systems.

    proj = FoldInProjector(artifact, max_batch=64)
    with MicroBatcher(proj.project, max_batch=64, max_delay_s=2e-3) as mb:
        fut = mb.submit(row)             # from any thread
        x = fut.result()                 # (k,) latent code

``stack`` controls how queued rows combine (default: ``torch.stack`` for
tensor rows, ``np.stack`` for anything else); pass a custom callable to
batch other request payloads.  The projection may return a tensor or an
array (each future resolves to its own row: a tensor row stays on the
projection's device) or a list/tuple of per-request payloads delivered
verbatim — the hook the online loop uses to stamp every response with the
artifact version it was computed against.  The worker never dies on a failing batch — the
exception is delivered to that batch's futures and the loop continues.

``swap(projector)`` hot-reloads the serving artifact in a RUNNING batcher:
the worker samples the projection callable once per coalesced batch, so the
swap takes effect at the next batch boundary — a batch already in flight
completes against the artifact it started with, and no queued request is
ever dropped or duplicated.  ``swap`` racing ``close()`` is defined too:
while the worker is still draining the queue the swap is accepted and the
remaining batches run the new projector; it is rejected only once the
worker has actually exited.  Either way every pending future is delivered
against a definite projector — never dropped, never deadlocked.

Metrics contract (``repro_torch.obs.metrics``, the reference's names): every batcher registers its
series in a ``MetricsRegistry`` — the process default, or an injected
``registry=`` — under a process-unique ``instance`` label, so concurrent
batchers never mix counts while one Prometheus scrape sees them all:

    serve_batcher_requests_total{instance=...}   counter
    serve_batcher_batches_total{instance=...}    counter
    serve_batcher_batch_size{instance=...}       histogram (power-of-2)
    serve_batcher_batch_latency_s{instance=...}  histogram (per-batch project)

``MicroBatcher.stats`` (a ``BatcherStats``) is a live VIEW over those
instruments: bounded memory no matter how long the batcher serves
(``batch_sizes`` is a capped recent window; the full distribution lives
in the histogram buckets).  The worker also emits ``batcher.*`` spans
into the default tracer (``repro_torch.obs.trace``) when tracing is
enabled.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.obs.metrics import (SIZE_BUCKETS, default_registry,
                                     next_instance_label)
from repro_torch.obs.trace import span as _span

_STOP = object()


def _stack(rows: list):
    """Tensor rows stack as a tensor; anything else through numpy."""
    if all(isinstance(r, torch.Tensor) for r in rows):
        return torch.stack(rows)
    return np.stack(rows)


class BatcherStats:
    """Live view over one batcher's registry series (keeps the old
    attribute API: ``requests``, ``batches``, ``batch_sizes``,
    ``mean_batch``, ``max_batch_seen``).

    ``batch_sizes`` is a capped recent window (last ``RECENT_WINDOW``
    batches) — the compat spelling of what used to be an unbounded
    per-batch list; the full distribution is in the
    ``serve_batcher_batch_size`` histogram.
    """

    RECENT_WINDOW = 256

    def __init__(self, registry=None):
        reg = registry or default_registry()
        labels = {"instance": next_instance_label()}
        self._requests = reg.counter(
            "serve_batcher_requests_total", labels=labels,
            help="Fold-in requests submitted to the microbatcher")
        self._batches = reg.counter(
            "serve_batcher_batches_total", labels=labels,
            help="Coalesced batches dispatched to the projector")
        self._sizes = reg.histogram(
            "serve_batcher_batch_size", buckets=SIZE_BUCKETS, labels=labels,
            help="Requests per coalesced batch")
        self._latency = reg.histogram(
            "serve_batcher_batch_latency_s", labels=labels,
            help="Seconds spent projecting one coalesced batch")
        self._recent: collections.deque = collections.deque(
            maxlen=self.RECENT_WINDOW)

    def record_batch(self, size: int, latency_s: float | None = None) -> None:
        self._requests.inc(size)
        self._batches.inc()
        self._sizes.observe(size)
        if latency_s is not None:
            self._latency.observe(latency_s)
        self._recent.append(size)

    @property
    def requests(self) -> int:
        return int(self._requests.value)

    @property
    def batches(self) -> int:
        return int(self._batches.value)

    @property
    def batch_sizes(self) -> list:
        """Sizes of the most recent batches (capped window)."""
        return list(self._recent)

    @property
    def mean_batch(self) -> float:
        return self.requests / max(self.batches, 1)

    @property
    def max_batch_seen(self) -> int:
        m = self._sizes.max
        return 0 if self._sizes.count == 0 else int(m)


def _deliver(fut: Future, *, result=None, exc: BaseException | None = None):
    """Resolve a future, tolerating callers that already cancelled it —
    an InvalidStateError out of the worker loop would kill delivery for
    every later future in the batch."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass


class MicroBatcher:
    """Thread-safe request coalescing in front of a batched ``project``."""

    def __init__(self, project: Callable[[Any], Any], *, max_batch: int = 64,
                 max_delay_s: float = 2e-3,
                 stack: Callable[[list], Any] | None = None,
                 registry=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.project = project
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.stack = stack or _stack
        self.stats = BatcherStats(registry)
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        # serialises the closed-check-then-enqueue against close(): without
        # it a submit could read _closed == False, lose the CPU, and enqueue
        # after the worker already exited — a future no one ever resolves
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="microbatcher")
        self._worker.start()

    # -- client side --------------------------------------------------------

    def submit(self, row) -> Future:
        """Enqueue one request; resolves to the request's own result row."""
        fut: Future = Future()
        with _span("batcher.enqueue"):
            with self._lock:
                if self._closed:
                    raise RuntimeError("MicroBatcher is closed")
                # enqueued under the lock ⇒ strictly before close()'s
                # sentinel, so the FIFO worker always processes it before
                # exiting
                self._q.put((row, fut))
        return fut

    def swap(self, projector) -> None:
        """Atomically replace the projection target between coalesced
        batches (artifact hot-reload).

        ``projector`` is the new batched callable, or an object carrying
        one as ``.project`` (a ``serve.foldin.FoldInProjector`` built
        from the freshly published ``FactorArtifact``).  Requests already
        batched and dispatched resolve against the OLD artifact; every
        batch collected after the swap runs the new one.  Queued requests
        survive the swap untouched — the queue and the worker never stop.

        A swap racing ``close()`` lands as long as the worker is still
        draining: the publisher thread must never crash just because a
        shutdown started concurrently, and the drained batches then run
        against the (newer) projector it installed.  Only once the worker
        has exited — nothing left that could ever run the new projector —
        is the swap refused.
        """
        project = getattr(projector, "project", projector)
        if not callable(project):
            raise TypeError(f"swap() needs a callable or an object with a "
                            f".project method; got {type(projector).__name__}")
        with self._lock:
            if self._closed and not self._worker.is_alive():
                raise RuntimeError("MicroBatcher is closed")
            self.project = project

    def close(self) -> None:
        """Drain outstanding requests, then stop the worker."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(_STOP)
        self._worker.join()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker side --------------------------------------------------------

    def _collect(self) -> list | None:
        """Block for the first request, then coalesce until max_batch or
        the deadline relative to that first arrival."""
        first = self._q.get()
        if first is _STOP:
            return None
        batch = [first]
        deadline = time.monotonic() + self.max_delay_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is _STOP:
                self._q.put(_STOP)       # re-post for the outer loop
                break
            batch.append(item)
        return batch

    def _run(self) -> None:
        while True:
            with _span("batcher.coalesce"):
                batch = self._collect()
            if batch is None:
                return
            rows = [r for r, _ in batch]
            futs = [f for _, f in batch]
            # Sample the projection target ONCE per batch: a concurrent
            # swap() lands cleanly on the next batch boundary.
            project = self.project
            t0 = time.perf_counter()
            try:
                with _span("batcher.project", batch=len(batch)):
                    out = project(self.stack(rows))
                # Tensors and arrays deliver per-row; a list/tuple delivers
                # per-ITEM payloads verbatim (e.g. version-stamped results
                # — one (code, version) record per request).
                if not isinstance(out, (list, tuple, torch.Tensor)):
                    out = np.asarray(out)
                if len(out) != len(futs):
                    raise RuntimeError(
                        f"projector returned {len(out)} rows for a batch "
                        f"of {len(futs)} requests")
            except Exception as e:       # noqa: BLE001 — deliver, don't die
                for f in futs:
                    _deliver(f, exc=e)
                continue
            finally:
                self.stats.record_batch(len(batch),
                                        time.perf_counter() - t0)
            with _span("batcher.deliver", batch=len(batch)):
                for i, f in enumerate(futs):
                    _deliver(f, result=out[i])
