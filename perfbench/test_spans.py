"""CPU tests of ``spans.py`` at tiny sizes, run by hand:

    python -m pytest -p no:cacheprovider perfbench/test_spans.py

On the CPU a device span is a host span, so the readings are host times:
these tests check the record's keys and arithmetic, not a device time.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

import harness  # noqa: E402
import spans  # noqa: E402

CPU = torch.device("cpu")
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY = {"dense": {"m": 600, "n": 96, "k": 8},
        "sparse": {"m": 1024, "n": 1024, "k": 8, "nnz": 8840}}
PHASES = {"gram_w", "mm_w", "luc_w", "gram_h", "mm_h", "luc_h", "error"}


def tiny_segments(cell_name: str) -> harness.Segments:
    cell = harness.Cell(ROOT, cell_name)
    cell.cfg = {**cell.cfg, **TINY[cell.cfg["storage"]]}
    return spans.prepare(cell, 2**31 + 11, CPU)


@pytest.mark.parametrize("cell", CELLS)
def test_span_window_reads_every_phase(cell, capsys):
    from repro_torch.obs.trace import default_tracer
    seg = tiny_segments(cell)
    rec = spans.span_window(seg, 0.05)
    assert set(rec["span_ms"]) == PHASES | {"iteration"}
    assert rec["span_iters"] % seg.iters == 0 and rec["span_iters"] > 0
    assert all(v > 0 for v in rec["span_ms"].values())
    assert sum(rec["span_ms"][p] for p in PHASES) <= \
        rec["span_ms"]["iteration"]
    assert rec["span_annotations"] == {
        f"phase.{p}": seg.iters for p in PHASES | {"iteration"}}
    assert set(spans.readings(rec)) == set(spans.READINGS)
    err = capsys.readouterr().err
    assert all(line.startswith("span-idle ") for line in err.splitlines())
    tr = default_tracer()
    assert not tr.enabled and tr.spans() == []


def test_measure_reports_the_readings_beside_the_outside_ones():
    rec = spans.measure(tiny_segments("webbase-hals"), 0.05)
    assert len(rec["unprofiled_iter_ms"]) == 2
    assert set(rec["readings"]) == set(spans.READINGS)
    assert {"mm_w", "luc_w"} <= set(rec["phase_ms"])
    assert rec["span_sum_share"] > 0 and "tracing_cost" in rec
    assert rec["annotations_off"] == {}


def test_readings_sum_their_phases_and_skip_what_is_missing():
    rec = {"span_ms": {"mm_w": 30.0, "mm_h": 34.5, "gram_w": 0.2,
                       "gram_h": 0.25, "luc_w": 185.0, "luc_h": 5.4,
                       "error": 0.6, "iteration": 256.0}}
    assert spans.readings(rec) == {
        "span.mm_ms": 64.5, "span.gram_ms": 0.45, "span.luc_w_ms": 185.0,
        "span.luc_h_ms": 5.4, "span.error_ms": 0.6}
    del rec["span_ms"]["mm_h"]
    assert "span.mm_ms" not in spans.readings(rec)
    assert spans.readings({}) == {}


def test_idle_gaps_go_to_the_innermost_phase():
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [
        x("user_annotation", "phase.iteration", 0, 100),
        x("user_annotation", "phase.mm_w", 0, 40),
        x("user_annotation", "phase.luc_w", 52, 40),
        x("cpu_op", "aten::mm", 1, 30),
        x("kernel", "k1", 10, 20),          # gap 30..35: mm_w
        x("kernel", "k2", 35, 10),          # gap 45..55: iteration
        x("kernel", "k3", 55, 20),          # gap 75..85: luc_w
        x("kernel", "k4", 85, 30),          # gap 115..125: outside
        x("kernel", "k5", 125, 5),
    ]
    assert spans.idle_by_phase(events) == {
        "mm_w": 5.0, "iteration": 10.0, "luc_w": 10.0, "outside": 10.0}
    assert spans.annotations(events) == {
        "phase.iteration": 1, "phase.mm_w": 1, "phase.luc_w": 1}


def test_span_window_on_a_program_without_spans(capsys):
    class Quiet:
        iters = 4

        class solver:
            device = CPU

        def run(self):
            time.sleep(0.01)
            return torch.zeros(4)

    rec = spans.span_window(Quiet(), 0.03)
    assert rec["span_ms"] == {} and rec["span_annotations"] == {}
    assert spans.readings(rec) == {}
    assert rec["span_iters"] >= 4
