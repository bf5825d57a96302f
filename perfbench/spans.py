"""The program's device-timed phase spans in one cell of the benchmark.

    python3 perfbench/spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on the CUDA device.  The port's serial step
records each phase (``phase.gram_w`` … ``phase.error``) and each iteration
(``phase.iteration``) as a device span of the process-default tracer:
CUDA events read at the read-back each segment already makes.  This
script sets the cell up as ``run.py`` does (``harness``) and, in one
process, runs:

  off       whole segments for ``seconds``, the tracer disabled: the
            unprofiled ms an iteration, as the traced run's
            ``unprofiled_iter_ms``;
  spans     ``span_window``: whole segments for ``seconds`` with the
            tracer enabled, each phase's mean device ms an iteration, then
            one segment under ``torch.profiler`` with the tracer on, its
            idle gaps put down to the phase whose range covers them (one
            ``span-idle <phase> <ms an iteration>`` line each on standard
            error);
  off       as the first, so that the two bracket the traced window;
  phases    ``harness.phase_window`` for ``seconds``: ``obs.phases``'
            per-phase times, each phase between two synchronisations;
  profiled  ``harness.profiled_segment`` with the tracer off: the kernels
            by name, as the traced run's ``breakdown``; and one more
            segment under the profiler, whose ``phase.*`` ranges it counts
            (none while the tracer is off).

and prints one JSON object as the last line of standard output: the span
readings (``READINGS``) beside the outside ones and the cost of tracing.
The benchmark's ``run.py`` does not call it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(ROOT / "src"), str(HERE)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import devtrace  # noqa: E402
import gen  # noqa: E402
import harness  # noqa: E402

#: the per-layer readings of the phase spans: name -> the phases it sums
READINGS = {"span.mm_ms": ("mm_w", "mm_h"),
            "span.gram_ms": ("gram_w", "gram_h"),
            "span.luc_w_ms": ("luc_w",),
            "span.luc_h_ms": ("luc_h",),
            "span.error_ms": ("error",)}

PREFIX = "phase."


def readings(rec: dict) -> dict:
    """Each reading of ``READINGS`` whose phases ``rec["span_ms"]`` has."""
    span_ms = rec.get("span_ms", {})
    return {name: sum(span_ms[k] for k in keys)
            for name, keys in READINGS.items()
            if all(k in span_ms for k in keys)}


def idle_by_phase(events: list) -> dict:
    """Device idle µs of a profiler trace (``devtrace.load``) by the
    innermost ``phase.*`` range that covers each gap's middle, without
    the prefix: a phase key, ``iteration`` between two phases, ``outside``
    outside every iteration."""
    dev = devtrace._union(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
        if e.get("cat") in devtrace.DEVICE_CATS)
    ranges = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"][len(PREFIX):]) for e in events
                     if e.get("cat") == "user_annotation"
                     and e["name"].startswith(PREFIX)),
                    key=lambda r: (r[0], -r[1]))
    holes = [(end, start) for (_, end), (start, _) in zip(dev, dev[1:])]
    idle: dict[str, float] = {}
    labels = devtrace._host_labels(ranges, [(e + s) / 2 for e, s in holes])
    for (end, start), label in zip(holes, labels):
        if label == "host idle or untraced":
            label = "outside"
        idle[label] = idle.get(label, 0.0) + (start - end)
    return idle


def annotations(events: list) -> dict:
    """How many ``phase.*`` ranges of each name a profiler trace holds."""
    out: dict[str, int] = {}
    for e in events:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith(PREFIX):
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def profiled_events(seg: harness.Segments, device) -> list:
    """The events of one segment under ``torch.profiler``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        seg.run()
        harness._sync(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return devtrace.load(path)


def span_window(seg: harness.Segments, seconds: float) -> dict:
    """Whole segments for ``seconds`` with the process-default tracer
    enabled: ``{"span_ms": {phase key: mean device ms an iteration},
    "span_iters": iterations, "span_window_iter_ms": the window's host ms
    an iteration, "span_idle_ms": {phase: idle ms an iteration},
    "span_annotations": {range name: count}}``, the last two from one more
    segment under ``torch.profiler``.  A program that records no phase
    spans gives empty dicts.  The tracer is disabled and emptied at the
    end."""
    from repro_torch.obs.trace import default_tracer
    device = seg.solver.device
    tracer = default_tracer()
    tracer.clear()
    tracer.enable()
    try:
        totals: dict[str, float] = {}
        segments = 0
        harness._sync(device)
        t0 = time.perf_counter()
        while True:
            seg.run()
            segments += 1
            for e in tracer.spans():
                if e.name.startswith(PREFIX):
                    key = e.name[len(PREFIX):]
                    totals[key] = totals.get(key, 0.0) + e.dur_us
            tracer.clear()
            if time.perf_counter() - t0 >= seconds:
                break
        harness._sync(device)
        iters = segments * seg.iters
        rec = {"span_ms": {k: us / 1e3 / iters for k, us in totals.items()},
               "span_iters": iters,
               "span_window_iter_ms":
                   1e3 * (time.perf_counter() - t0) / iters}
        events = profiled_events(seg, device)
    finally:
        tracer.disable()
        tracer.clear()
    rec["span_idle_ms"] = {k: us / 1e3 / seg.iters
                           for k, us in idle_by_phase(events).items()}
    rec["span_annotations"] = annotations(events)
    for phase, ms in sorted(rec["span_idle_ms"].items()):
        print(f"span-idle {phase} {ms!r}", file=sys.stderr)
    return rec


def prepare(cell: harness.Cell, seed: int, device) -> harness.Segments:
    """The cell's set-up as ``harness.run`` makes it, warm-up included."""
    cfg, traffic = cell.cfg, cell.traffic
    inputs = gen.make_inputs(cfg, traffic, seed, device)
    solver = harness.solver_for(cfg, traffic, device)
    with warnings.catch_warnings():          # the COO's invariants hold
        warnings.simplefilter("ignore")
        A = harness.program_input(cfg, inputs)
    seg = harness.Segments(solver, A, inputs["W0"], inputs["H0"])
    del A, inputs
    seg.run()
    return seg


def measure(seg: harness.Segments, seconds: float) -> dict:
    """The five stages of the module's docstring, on a prepared cell."""
    device = seg.solver.device
    off = [harness.window(seg, seconds, device)]
    rec = span_window(seg, seconds)
    off.append(harness.window(seg, seconds, device))
    rec["unprofiled_iter_ms"] = [1e3 * w["window_s"] / w["iters"]
                                 for w in off]
    rec["phase_ms"] = harness.phase_window(seg, seconds)
    rec["device_ops"] = harness.profiled_segment(seg, device)["device_ops"]
    rec["annotations_off"] = annotations(profiled_events(seg, device))
    rec["readings"] = readings(rec)
    base = sum(rec["unprofiled_iter_ms"]) / len(off)
    rec["span_sum_share"] = (sum(rec["readings"].values()) / base
                             if rec["readings"] else None)
    rec["tracing_cost"] = rec["span_window_iter_ms"] / base - 1.0
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spans: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seg = prepare(harness.Cell(ROOT, args.workload), args.seed, device)
    rec = measure(seg, args.seconds)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(device), **rec}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
