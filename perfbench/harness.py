"""One run of one cell of the port's benchmark.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``configs/<name>.json``: the data matrix's shape, storage, generator and
rank k, the port's backend for it, and its schedule on a grid of cards:
``"schedule"``, serial unless named, and ``"grid": [pr, pc]``, whose
pr·pc is the cell's ``chips``) under a traffic mix
(``traffic/<name>.json``: the update rule, the iterations of a segment and
the starting W).  ``workloads/<cell>.json`` holds the limits of the
numbers that decide ``correct``; ``metrics/<name>.py`` reads one metric
from the run's record.  All are found by name.

A run:

  set-up   the inputs from the seed (``gen``), ``NMFSolver.prepare_state``
           once (A laid out, ‖A‖²), and one warm-up segment;
  window   whole segments for ``seconds``: each restarts from the
           starting factors set-up made, with a fresh rule state, so every
           segment does the same work (``run_segment``: one read-back of
           the relative errors a segment);
  traced   (``trace``) a third of the window unprofiled on the host
           clock, one segment under ``torch.profiler``, and a third
           through ``obs.phases.run_profiled`` (each phase between two
           device synchronisations);
  judged   once the window has closed, the peak read and the program's
           state freed: the last segment's factors and relative errors
           against the plain reference's from the same inputs
           (``judge``).

A ranked cell (more than one chip, or a schedule other than serial) runs
``run`` on every rank of a process group that ``launch`` starts, one card
each (``ranks``): each rank draws only its block's triplets, rank 0 ends
the window for all, and the reference and the judge are split across the
ranks.  A serial one-chip cell runs in the calling process.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
import warnings
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import counts  # noqa: E402
import devtrace  # noqa: E402
import gen  # noqa: E402
import judge  # noqa: E402
import reference  # noqa: E402

#: the schedules a cell may name: the program's serial one, and faun on a
#: pr × pc grid (``make_faun_grid``)
SCHEDULES = ("serial", "faun")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """A cell's configuration, traffic, limits and metrics, by name."""

    def __init__(self, root: Path, name: str):
        bench = load_json(root / "BENCHMARK.json")
        self.entry = _named(bench["workloads"], name, "workload")
        cfg_entry = _named(bench["configs"], self.entry["config"],
                           "configuration")
        self.cfg = load_json(root / cfg_entry["file"])
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.entry['traffic']}.json")
        limits = HERE / "workloads" / f"{name}.json"
        self.limits = load_json(limits)["limits"] if limits.exists() else {}
        self.chips = self.entry["chips"]
        self.schedule = self.cfg.get("schedule", "serial")
        pr, pc = self.cfg.get("grid", (1, 1))
        if self.schedule not in SCHEDULES:
            raise ValueError(f"configuration {cfg_entry['name']!r}: schedule "
                             f"{self.schedule!r} is not one of {SCHEDULES}")
        if pr * pc != self.chips or (self.schedule == "serial"
                                     and pr * pc != 1):
            raise ValueError(f"cell {name!r}: {self.chips} chip(s) for a "
                             f"{self.schedule} {pr} × {pc} grid")
        #: whether the cell runs on ranks started by ``launch``
        self.ranked = self.chips > 1 or self.schedule != "serial"

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        self.end_to_end = mine(bench["end_to_end"])
        self.per_layer = mine(bench["per_layer"])


def reader(name: str):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(specs: list, rec: dict) -> dict:
    out = {}
    for spec in specs:
        value = reader(spec["name"])(rec)
        if value is not None:
            out[spec["name"]] = {"value": value, "unit": spec["unit"]}
    return out


# ---------------------------------------------------------------------------
# The program's side
# ---------------------------------------------------------------------------

def solver_for(cfg: dict, traffic: dict, device: torch.device):
    """The program's solver; on a grid, every rank calls it in the same
    order (``make_faun_grid`` makes process groups)."""
    from repro_torch.backends import SparseOps
    from repro_torch.core.engine import NMFSolver
    backend = (SparseOps(spmm_impl=cfg["spmm_impl"])
               if cfg["backend"] == "sparse" else cfg["backend"])
    kw = {}
    if cfg.get("schedule", "serial") != "serial":
        from repro_torch.core.faun import make_faun_grid
        kw = {"schedule": cfg["schedule"],
              "grid": make_faun_grid(*cfg["grid"])}
    return NMFSolver(cfg["k"], algo=traffic["rule"], backend=backend,
                     device=device, max_iters=traffic["segment_iters"], **kw)


def program_input(cfg: dict, inputs: dict):
    """A as a user hands it to the port: the dense tensor, or a coalesced
    COO tensor of the triplets (the port blockifies and sorts it)."""
    if "A" in inputs:
        return inputs["A"]
    return torch.sparse_coo_tensor(inputs["indices"], inputs["values"],
                                   (cfg["m"], cfg["n"]), is_coalesced=True,
                                   check_invariants=False)


class Segments:
    """Whole segments of ``iters`` iterations, each from the same start."""

    def __init__(self, solver, A, W0, H0):
        self.solver, self.iters = solver, solver.stopping.max_iters
        self.rs = solver.prepare_state(A, W0=W0, H0=H0)
        self.W_start, self.Ht_start = self.rs.W, self.rs.Ht
        self.state_start = copy.deepcopy(self.rs.state)

    def reset(self):
        rs = self.rs
        rs.W, rs.Ht = self.W_start.clone(), self.Ht_start.clone()
        rs.state = copy.deepcopy(self.state_start)
        rs.rel_history, rs.step = [], 0

    def run(self) -> torch.Tensor:
        """One segment; its relative errors (on the host)."""
        self.reset()
        self.solver.run_segment(self.rs, self.iters)
        return self.rs.rel_history[-1]


def program_output(seg: Segments, iters: int) -> dict:
    """What the check compares: the factors and relative errors of a
    segment of ``iters`` from the same start, run through ``run_segment``
    once the window has closed."""
    seg.reset()
    seg.solver.run_segment(seg.rs, iters)
    return {"W": seg.rs.W, "Ht": seg.rs.Ht,
            "rels": [float(x) for x in seg.rs.rel_history[-1]]}


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _more(start: float, seconds: float, ranks) -> bool:
    """Whether another segment runs: ``seconds`` not yet passed since
    ``start``, by rank 0's clock on a grid."""
    more = time.perf_counter() - start < seconds
    return more if ranks is None else ranks.agree(more)


def window(seg: Segments, seconds: float, device, ranks=None) -> dict:
    """Whole segments until ``seconds`` have passed; on a grid (``ranks``)
    between two barriers, every rank running as many segments as rank 0
    decides, the segments with a non-finite error summed over the
    ranks."""
    _sync(device)
    if ranks is not None:
        ranks.barrier()
    t0 = time.perf_counter()
    segments = nonfinite = 0
    while True:
        rels = seg.run()
        segments += 1
        nonfinite += int(not bool(torch.isfinite(rels).all()))
        if not _more(t0, seconds, ranks):
            break
    _sync(device)
    if ranks is not None:
        ranks.barrier()
    window_s = time.perf_counter() - t0
    if ranks is not None:
        nonfinite = int(ranks.sum(nonfinite))
    return {"window_s": window_s, "segments": segments,
            "iters": segments * seg.iters, "nonfinite": nonfinite}


def profiled_segment(seg: Segments, device) -> dict:
    """One segment under ``torch.profiler``: the trace's summary, and the
    traced window's length on the host clock."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        _sync(device)
        t0 = time.perf_counter()
        seg.run()
        _sync(device)
        traced_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        summary = devtrace.summarize(devtrace.load(path))
    summary["window_s"] = traced_s
    return summary


def phase_window(seg: Segments, seconds: float, ranks=None) -> dict:
    """Mean ms an iteration of each phase, over whole profiled segments
    for ``seconds`` (``obs.phases.run_profiled``; on a grid, as many as
    rank 0 decides)."""
    from repro_torch.obs.phases import run_profiled
    totals: dict[str, float] = {}
    iters = 0
    t0 = time.perf_counter()
    while True:
        seg.reset()
        for phase, s in run_profiled(seg.solver, seg.rs).items():
            totals[phase] = totals.get(phase, 0.0) + s * seg.iters
        iters += seg.iters
        if not _more(t0, seconds, ranks):
            break
    return {phase: 1e3 * s / iters for phase, s in totals.items()}


# ---------------------------------------------------------------------------
# The reference's side
# ---------------------------------------------------------------------------

def products(cfg: dict, inputs: dict, **kw) -> reference.Products:
    if "A" in inputs:
        return reference.Products(A=inputs["A"], **kw)
    return reference.Products(indices=inputs["indices"],
                              values=inputs["values"],
                              shape=(cfg["m"], cfg["n"]), **kw)


def check_iters(traffic: dict) -> int:
    """The iterations from the start that the check compares: the whole
    segment, or its first ``check_iters`` where a fit's later iterations
    amplify rounding beyond any limit (PERF.md)."""
    return traffic.get("check_iters", traffic["segment_iters"])


def reference_segment(cfg: dict, traffic: dict, inputs: dict, *,
                      tf32: bool = False, dtype=torch.float32,
                      iters: int | None = None) -> dict:
    P = products(cfg, inputs, tf32=tf32, dtype=dtype)
    W, Ht, rels = reference.segment(
        P, traffic["rule"], inputs["W0"], inputs["H0"],
        check_iters(traffic) if iters is None else iters)
    return {"W": W, "Ht": Ht, "rels": rels}


def judge_outputs(cfg: dict, traffic: dict, inputs: dict, out: dict,
                  ref: dict | None = None) -> dict:
    """Every number of ``judge`` for the outputs ``out`` of one segment
    (the reference's segment computed here unless given)."""
    if ref is None:
        ref = reference_segment(cfg, traffic, inputs)
    with reference.exact_fp32():
        exact = reference.rel_error(products(cfg, inputs,
                                             dtype=torch.float64),
                                    out["W"], out["Ht"])
    return judge.numbers(out, ref, exact)


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def device_info(device: torch.device, peak: int, count: int = 1) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": peak}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": peak}


def run(root: Path, name: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float) -> dict:
    """One run of cell ``name``; the result line's object.  ``t_start``
    is the process's start on the host clock (``time.perf_counter``).  A
    ranked cell's every rank calls it on its own card, in a process group
    of the cell's chips (``launch``); rank 0's object is the run's."""
    cell = Cell(root, name)
    cfg, traffic = cell.cfg, cell.traffic
    marks = [("imports", time.perf_counter())]

    def mark(stage: str):
        _sync(device)
        marks.append((stage, time.perf_counter()))

    torch.empty(1, device=device)
    ranks = None
    if cell.ranked:
        import ranks as _ranks
        ranks = _ranks.Ranks(cfg, device)
    mark("device_init")
    place = (ranks.shape, ranks.block) if ranks is not None else ()
    inputs = gen.make_inputs(cfg, traffic, seed, device, *place)
    mark("inputs")
    solver = solver_for(cfg, traffic, device)
    with warnings.catch_warnings():          # the COO's invariants hold
        warnings.simplefilter("ignore")
        A = program_input(cfg, inputs)
    mark("solver")
    if ranks is None:
        seg = Segments(solver, A, inputs["W0"], inputs["H0"])
    else:        # not held through the window: drawn again for the judge
        seg = Segments(solver, A, inputs.pop("W0"), inputs.pop("H0"))
    del A
    mark("prepare")
    seg.run()
    if ranks is not None:
        ranks.barrier()
    mark("warmup")
    rec = {"prepare_s": marks[-2][1] - marks[-3][1],
           "setup_s": marks[-1][1] - t_start,
           "setup_parts": {stage: t - t_prev for (_, t_prev), (stage, t)
                           in zip([("start", t_start)] + marks, marks)}}
    if device.type == "cuda":
        rec["setup_parts"]["peak_gb_after_setup"] = (
            torch.cuda.max_memory_allocated(device) / 1e9)
    if ranks is None or ranks.rank == 0:
        print("setup " + " ".join(f"{k} {v:.3f}" for k, v in
                                  rec["setup_parts"].items()),
              file=sys.stderr)
    if trace:
        rec.update(window(seg, seconds / 3, device, ranks))
        rec["unprofiled_iter_ms"] = 1e3 * rec["window_s"] / rec["iters"]
        rec["trace"] = profiled_segment(seg, device)
        pair = [rec["trace"]["busy_s"], rec["trace"]["window_s"]]
        rec["trace"]["ranks"] = ([pair] if ranks is None
                                 else ranks.gather(pair))
        rec["phase_ms"] = phase_window(seg, seconds / 3, ranks)
        rec["least_ms"] = counts.least_by_group(cfg, traffic["rule"],
                                                cell.chips)
    else:
        rec.update(window(seg, seconds, device, ranks))
    out = program_output(seg, check_iters(traffic))
    rec["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                         if device.type == "cuda" else 0)
    if ranks is not None:
        peaks = [int(b) for (b,) in ranks.gather([rec["peak_bytes"]])]
        rec["peak_bytes"] = max(peaks)
        if ranks.rank == 0:
            print("peak_gb by rank " + " ".join(f"{b / 1e9:.4f}"
                                               for b in peaks),
                  file=sys.stderr)
    del seg, solver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if ranks is None:
        nums = judge_outputs(cfg, traffic, inputs, out)
    else:
        ranks.localize(inputs)
        ref = ranks.segment(ranks.products(inputs), cfg, traffic, seed,
                            check_iters(traffic))
        nums = ranks.judge_outputs(inputs, out, ref)
    correct, checks = judge.decide(nums, cell.limits)
    result = {"correct": correct and rec["nonfinite"] == 0,
              "attempted": rec["segments"], "failed": rec["nonfinite"],
              "metrics": read_metrics(cell.per_layer if trace
                                      else cell.end_to_end, rec),
              "device": device_info(device, rec["peak_bytes"], cell.chips)}
    if trace:
        busy, spans = zip(*rec["trace"]["ranks"])
        result["device"]["busy_s"] = sum(busy) / len(busy)
        result["device"]["window_s"] = sum(spans) / len(spans)
        result["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                               "idle_gaps": rec["trace"]["idle_gaps"]}
    result["checks"] = checks
    return result
