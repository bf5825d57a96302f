"""Readings for the limits of a cell's numbers (``judge``).

    python3 perfbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 11 12 13]

For each seed, in one process: the inputs, the program's segment as the
window runs it (``harness.Segments``; the check's first iterations of
one where the traffic names ``check_iters``), the
plain reference's segment, and the numbers of ``judge`` for the program;
for the control seeds also the numbers of the control (the reference
computed in TF32, ``reference.Products(tf32=True)``) against the same
reference.  One JSON line a seed on standard output.  The largest program
reading over the seeds is a number's lower reading, the smallest control
reading its upper one.  A ranked cell reads every seed in one process
group of its chips (``launch``), through the split reference and judge
(``ranks``), and takes no witness seeds.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402

import gen  # noqa: E402
import harness  # noqa: E402


def readings(cell: harness.Cell, seed: int, control: bool, witness: bool,
             device: torch.device) -> dict:
    cfg, traffic = cell.cfg, cell.traffic
    inputs = gen.make_inputs(cfg, traffic, seed, device)
    solver = harness.solver_for(cfg, traffic, device)
    seg = harness.Segments(solver, harness.program_input(cfg, inputs),
                           inputs["W0"], inputs["H0"])
    seg.run()
    out = harness.program_output(seg, harness.check_iters(traffic))
    del seg, solver
    gc.collect()
    t0 = time.perf_counter()
    ref = harness.reference_segment(cfg, traffic, inputs)
    row = {"seed": seed, "rels": out["rels"], "ref_rels": ref["rels"],
           "program": harness.judge_outputs(cfg, traffic, inputs, out, ref)}
    row["reference_s"] = time.perf_counter() - t0
    if control:
        ctl = harness.reference_segment(cfg, traffic, inputs, tf32=True)
        row["control"] = harness.judge_outputs(cfg, traffic, inputs, ctl,
                                               ref)
    if witness:    # the fp32 reference against itself in float64, whole
        iters = traffic["segment_iters"]
        f32 = ref if iters == harness.check_iters(traffic) else (
            harness.reference_segment(cfg, traffic, inputs, iters=iters))
        f64 = harness.reference_segment(cfg, traffic, inputs, iters=iters,
                                        dtype=torch.float64)
        row["witness"] = harness.judge_outputs(cfg, traffic, inputs, f32,
                                               f64)
        row["witness_rels"] = {"fp32": f32["rels"], "f64": f64["rels"]}
    return row


def ranked_readings(device: torch.device, root: str, name: str, seeds: list,
                    control_seeds: list) -> list:
    """``readings`` of every seed on one rank of a ranked cell (a
    ``launch.ranks`` target): rank 0's rows are the run's."""
    import ranks as _ranks
    cell = harness.Cell(Path(root), name)
    cfg, traffic = cell.cfg, cell.traffic
    r = _ranks.Ranks(cfg, device)
    iters = harness.check_iters(traffic)
    rows = []
    for seed in seeds:
        inputs = gen.make_inputs(cfg, traffic, seed, device, r.shape,
                                 r.block)
        solver = harness.solver_for(cfg, traffic, device)
        seg = harness.Segments(solver, harness.program_input(cfg, inputs),
                               inputs.pop("W0"), inputs.pop("H0"))
        seg.run()
        out = harness.program_output(seg, iters)
        del seg, solver
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        r.localize(inputs)
        t0 = time.perf_counter()
        ref = r.segment(r.products(inputs), cfg, traffic, seed, iters)
        row = {"seed": seed, "rels": out["rels"], "ref_rels": ref["rels"],
               "program": r.judge_outputs(inputs, out, ref)}
        row["reference_s"] = time.perf_counter() - t0
        if seed in control_seeds:
            ctl = r.segment(r.products(inputs, tf32=True), cfg, traffic,
                            seed, iters)
            row["control"] = r.judge_outputs(inputs, ctl, ref)
        rows.append(row)
        del inputs, out, ref
        gc.collect()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    cell = harness.Cell(ROOT, args.workload)
    if cell.ranked:
        if args.witness_seeds:
            ap.error("a ranked cell takes no witness seeds")
        import launch
        rows = launch.ranks(cell.chips, ranked_readings,
                            (str(ROOT), args.workload, args.seeds,
                             args.control_seeds), device_type=device.type)
        if rows is None:
            return 1
        for row in rows:
            print(json.dumps(row), flush=True)
        return 0
    for seed in args.seeds:
        row = readings(cell, seed, seed in args.control_seeds,
                       seed in args.witness_seeds, device)
        print(json.dumps(row), flush=True)
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
