"""Unified metrics registry: counters, gauges, and fixed-bucket histograms.
A copy of ``repro/obs/metrics.py`` (which imports no JAX): the same series
names, the same Prometheus text and the same JSONL snapshots, so
dashboards and tests read both packages alike.

Every serving statistic in the package flows through ONE
surface so operators scrape a single endpoint instead of poking Python
attributes: ``MetricsRegistry`` holds named instruments (optionally
labelled, Prometheus-style), is thread-safe under concurrent writers (the
microbatcher worker and N client threads all write at once), and exports two ways —

  * ``to_prometheus()``  — Prometheus text exposition format (scrapeable);
  * ``export_jsonl(path)`` — append one timestamped JSON snapshot line
    (the benchmarks' machine-readable dump).

Instruments are cheap handles; get-or-create is idempotent so independent
modules can name the same series.  A process-default registry
(``default_registry()``) serves the common case; anything accepting a
``registry=`` keyword (``MicroBatcher``) can be pointed at
an injected one instead — tests isolate themselves that way.

    reg = default_registry()
    reg.counter("serve_requests_total").inc()
    reg.histogram("fold_latency_s", buckets=LATENCY_BUCKETS_S).observe(dt)
    print(reg.to_prometheus())

Per-instance views (``BatcherStats``) label their series
with a process-unique ``instance`` label, so two live batchers never mix
counts while one scrape still sees both.
"""

from __future__ import annotations

import itertools
import json
import math
import threading
import time
from typing import Iterable

#: default latency buckets (seconds): 100µs … ~100s, roughly ×3 apart
LATENCY_BUCKETS_S = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0,
                     3.0, 10.0, 30.0, 100.0)

#: default size buckets (counts): powers of two 1 … 4096
SIZE_BUCKETS = tuple(float(2 ** i) for i in range(13))

_instance_ids = itertools.count()


def next_instance_label() -> str:
    """A process-unique label value for per-instance metric series."""
    return str(next(_instance_ids))


class Counter:
    """Monotonically increasing count (requests served, rows ingested)."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: tuple = ()):
        self.name, self.labels = name, labels
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up; inc({amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """A value that goes both ways (current version, queue depth)."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: tuple = ()):
        self.name, self.labels = name, labels
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Fixed-bucket histogram (latencies, batch sizes): O(1) memory no
    matter how long the process lives — the registry's answer to keeping
    an unbounded list of every observation.

    ``buckets`` are inclusive upper bounds; a final +Inf bucket is always
    appended.  ``counts`` are per-bucket (non-cumulative); the Prometheus
    exposition cumulates them as the format requires.
    """

    __slots__ = ("name", "labels", "buckets", "_lock", "_counts", "_sum",
                 "_count", "_max")

    def __init__(self, name: str, buckets: Iterable[float] = LATENCY_BUCKETS_S,
                 labels: tuple = ()):
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.name, self.labels = name, labels
        self.buckets = bs
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)          # + overflow (+Inf)
        self._sum = 0.0
        self._count = 0
        self._max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):        # short ladders: linear
            if v <= b:
                i = j
                break
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def max(self) -> float:
        """Largest value observed (-inf before any observation)."""
        return self._max

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def counts(self) -> tuple[int, ...]:
        """Per-bucket counts (last entry is the +Inf overflow bucket)."""
        with self._lock:
            return tuple(self._counts)

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper bound of the bucket
        the q-th observation falls in; +Inf bucket reports the max seen)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile needs 0 <= q <= 1, got {q}")
        with self._lock:
            total = self._count
            if not total:
                return 0.0
            target = q * total
            acc = 0
            for j, c in enumerate(self._counts):
                acc += c
                if acc >= target:
                    return self.buckets[j] if j < len(self.buckets) \
                        else self._max
            return self._max


def _fmt_labels(labels: tuple, extra: tuple = ()) -> str:
    items = tuple(labels) + tuple(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer():
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Thread-safe, get-or-create home of named metric instruments.

    Series are keyed on (name, sorted label items); asking for an existing
    key returns the same instrument (so modules never need to coordinate
    creation), asking with a conflicting instrument kind raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, object] = {}
        self._help: dict[str, str] = {}

    # -- instrument accessors ------------------------------------------------

    def _get(self, cls, name: str, labels: dict | None, help: str | None,
             **kwargs):
        lab = tuple(sorted((labels or {}).items()))
        key = (name, lab)
        with self._lock:
            inst = self._metrics.get(key)
            if inst is None:
                inst = cls(name, labels=lab, **kwargs)
                self._metrics[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(inst).__name__}, not {cls.__name__}")
            if help:
                self._help[name] = help
            return inst

    def counter(self, name: str, *, labels: dict | None = None,
                help: str | None = None) -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, *, labels: dict | None = None,
              help: str | None = None) -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, *, buckets=LATENCY_BUCKETS_S,
                  labels: dict | None = None,
                  help: str | None = None) -> Histogram:
        return self._get(Histogram, name, labels, help, buckets=buckets)

    # -- introspection / export ---------------------------------------------

    def collect(self) -> list:
        """All registered instruments, registration-ordered."""
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> dict:
        """Plain-data snapshot of every series (JSON-serialisable)."""
        out: dict = {}
        for m in self.collect():
            key = m.name + _fmt_labels(m.labels)
            if isinstance(m, Histogram):
                out[key] = {"count": m.count, "sum": m.sum,
                            "max": (None if m.count == 0 else m.max),
                            "buckets": list(m.buckets),
                            "counts": list(m.counts)}
            else:
                out[key] = m.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4) of every series."""
        by_name: dict[str, list] = {}
        for m in self.collect():
            by_name.setdefault(m.name, []).append(m)
        lines: list[str] = []
        for name, series in by_name.items():
            help_ = self._help.get(name)
            if help_:
                lines.append(f"# HELP {name} {help_}")
            kind = {Counter: "counter", Gauge: "gauge",
                    Histogram: "histogram"}[type(series[0])]
            lines.append(f"# TYPE {name} {kind}")
            for m in series:
                if isinstance(m, Histogram):
                    acc = 0
                    counts = m.counts
                    for b, c in zip(m.buckets + (math.inf,), counts):
                        acc += c
                        lab = _fmt_labels(m.labels, (("le", _fmt_value(b)),))
                        lines.append(f"{name}_bucket{lab} {acc}")
                    lab = _fmt_labels(m.labels)
                    lines.append(f"{name}_sum{lab} {_fmt_value(m.sum)}")
                    lines.append(f"{name}_count{lab} {m.count}")
                else:
                    lab = _fmt_labels(m.labels)
                    lines.append(f"{name}{lab} {_fmt_value(m.value)}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export_jsonl(self, path: str) -> None:
        """Append one ``{"time": ..., "metrics": {...}}`` JSON line."""
        rec = {"time": time.time(), "metrics": self.snapshot()}
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-default registry every built-in instrument lands in
    unless an explicit ``registry=`` is injected."""
    return _DEFAULT
