"""Observability: metrics registry, tracing, and phase-level profiling —
the counterpart of ``repro.obs``.

  * ``repro_torch.obs.metrics`` — counters / gauges / histograms in a
    thread-safe ``MetricsRegistry`` with Prometheus + JSONL export; the
    serving layer's stats objects are views over it;
  * ``repro_torch.obs.trace``   — spans exported as Chrome/Perfetto
    trace-event JSON; the serving decision points emit into the
    process-default tracer (disabled, hence free, until enabled);
  * ``repro_torch.obs.phases``  — the segmented per-phase profiler behind
    ``NMFSolver.fit(profile=True)``, joined against the α-β-γ cost model
    by ``repro_torch.obs.report`` (measured against predicted).

``metrics``, ``trace`` and ``log`` import no JAX in the reference and are
copies of it: the same metric and span names, the same exports.
"""

from repro_torch.obs.log import get_logger, log_event
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     LATENCY_BUCKETS_S, MetricsRegistry,
                                     SIZE_BUCKETS, default_registry,
                                     next_instance_label)
from repro_torch.obs.phases import expected_phases, phase_group, run_profiled
from repro_torch.obs.report import (breakdown_report, format_report,
                                    merge_phase_times, run_all_schedules)
from repro_torch.obs.trace import SpanEvent, Tracer, default_tracer, span

__all__ = [
    "Counter", "Gauge", "Histogram", "LATENCY_BUCKETS_S", "MetricsRegistry",
    "SIZE_BUCKETS", "SpanEvent", "Tracer", "breakdown_report",
    "default_registry", "default_tracer", "expected_phases", "format_report",
    "get_logger", "log_event", "merge_phase_times", "next_instance_label",
    "phase_group", "run_all_schedules", "run_profiled", "span",
]
