"""CPU tests of a cell on a grid of ranks, at tiny sizes, run by hand:

    python -m pytest -p no:cacheprovider perfbench/test_ranks.py

The ranks are gloo processes on the CPU, started by the benchmark's own
launcher (``launch.ranks``); the port's plain PyTorch versions stand in for
its kernels.  A tiled Webbase-shaped configuration runs faun on 2 × 2 and
1 × 1 grids and serially.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(HERE))

import counts  # noqa: E402
import gen  # noqa: E402
import harness  # noqa: E402
import judge  # noqa: E402
import launch  # noqa: E402
import ranks  # noqa: E402
import reference  # noqa: E402
from test_perfbench import TINY, run_tiny, tiny_checkout  # noqa: E402

CPU = torch.device("cpu")
SEED = 2**31 + 913
#: a tiled Webbase-shaped configuration at a tiny size
TILED = {**json.loads((HERE / "configs" / "webbase-k50.json").read_text()),
         **TINY["sparse"], "name": "wb-tiled", "generator": "erdos_renyi_tiled",
         "tiles": 8}
TRAFFIC = {"mu": json.loads((HERE / "traffic" / "mu-seg10.json").read_text()),
           "hals": json.loads((HERE / "traffic" / "hals-seg4.json")
                              .read_text())}
LIMITS = {"mu": "webbase-mu", "hals": "webbase-hals"}


def grid_checkout(tmp: Path) -> Path:
    """A tiny checkout with the tiled configuration on a 2 × 2 faun grid
    (cells ``wb2x2-mu``, ``wb2x2-hals``; 4 chips), a 1 × 1 faun grid
    (``wb1x1-*``) and serially (``wbser-*``), each with the limits of
    the webbase cell of its rule."""
    root = tiny_checkout(tmp)
    pb = root / "perfbench"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for tag, sched, grid in (("wb2x2", "faun", [2, 2]),
                             ("wb1x1", "faun", [1, 1]),
                             ("wbser", "serial", [1, 1])):
        cfg = {**TILED, "name": tag, "schedule": sched, "grid": grid}
        (pb / "configs" / f"{tag}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": tag, "source": "test",
                                 "file": f"perfbench/configs/{tag}.json",
                                 "reduced": [], "why": "test"})
        for rule, traffic in (("mu", "mu-seg10"), ("hals", "hals-seg4")):
            cell = f"{tag}-{rule}"
            bench["workloads"].append({"name": cell, "config": tag,
                                       "traffic": traffic,
                                       "chips": grid[0] * grid[1],
                                       "why": "test"})
            (pb / "workloads" / f"{cell}.json").write_text(
                (pb / "workloads" / f"{LIMITS[rule]}.json").read_text())
    for metric in bench["end_to_end"] + bench["per_layer"]:
        metric.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_ranked(root: Path, cell: str, seed: int = SEED, trace=False,
               timeout_s: float = 300.0):
    """One run of a ranked ``cell`` of ``root`` on gloo ranks, through the
    launcher, in a fresh interpreter: (its value, seconds, stdout)."""
    code = f"""
import json, sys, time
sys.path.insert(0, {str(ROOT / 'src')!r})
sys.path.insert(0, {str(root / 'perfbench')!r})
import multiprocessing, harness, launch
if __name__ == "__main__":
    cell = harness.Cell(harness.Path({str(root)!r}), {cell!r})
    t0 = time.perf_counter()
    r = launch.ranks(cell.chips, launch.run_cell,
                     ({str(root)!r}, {cell!r}, {seed}, 0.2, {trace}, t0),
                     device_type="cpu", timeout_s={timeout_s})
    print(json.dumps({{"value": r, "s": time.perf_counter() - t0,
                      "left": len(multiprocessing.active_children())}}),
          file=sys.stderr)
    if r is not None:
        print(json.dumps(r))
"""
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", code],
                         capture_output=True, text=True, check=True,
                         timeout=timeout_s + 120)
    tail = json.loads(out.stderr.strip().splitlines()[-1])
    assert tail["left"] == 0
    return tail["value"], tail["s"], out.stdout


# ---------------------------------------------------------------------------
# The tiled generator
# ---------------------------------------------------------------------------

def _linear(indices, n):
    return indices[0] * n + indices[1]


@pytest.mark.parametrize("grid", [(1, 2), (2, 1), (2, 2), (4, 2)])
def test_tiled_generator_draws_the_same_matrix_on_every_grid(grid):
    m, n, nnz, T = TILED["m"], TILED["n"], TILED["nnz"], TILED["tiles"]
    whole_idx, whole_val = gen.erdos_renyi_tiled(CPU, SEED, m, n, nnz, T)
    key = _linear(whole_idx, n)
    assert key.numel() == nnz and bool((key[1:] > key[:-1]).all())
    assert bool((whole_val > 0).all() and (whole_val <= 1).all())
    tile = (whole_idx[0] // (m // T)) * T + whole_idx[1] // (n // T)
    assert torch.bincount(tile, minlength=T * T).tolist() == [
        gen.tile_nnz(nnz, T, t) for t in range(T * T)]
    parts = []
    for i in range(grid[0]):
        for j in range(grid[1]):
            idx, val = gen.erdos_renyi_tiled(CPU, SEED, m, n, nnz, T, grid,
                                             (i, j))
            k = _linear(idx, n)
            assert bool((k[1:] > k[:-1]).all())      # coalesced: row-major
            assert bool((idx[0] // (m // grid[0]) == i).all())
            assert bool((idx[1] // (n // grid[1]) == j).all())
            parts.append((k, val))
    k = torch.cat([p[0] for p in parts])
    order = torch.argsort(k)
    assert torch.equal(k[order], key)
    assert torch.equal(torch.cat([p[1] for p in parts])[order], whole_val)


def test_tiled_generator_refuses_a_grid_that_splits_a_tile():
    with pytest.raises(ValueError):
        gen.erdos_renyi_tiled(CPU, SEED, 1024, 1024, 100, 8, (3, 1), (0, 0))
    with pytest.raises(ValueError):
        gen.make_inputs(TILED | {"generator": "erdos_renyi"}, TRAFFIC["mu"],
                        SEED, CPU, (2, 2), (0, 0))


#: sha256 of ``make_inputs`` at ``TINY``, seed 2**31 + 5, before the tiled
#: generator was added: the serial cells' inputs stay as they were
SERIAL_DIGESTS = {
    ("video-k50", "positive"):
        "3070614f38d46ec9950da323ac1d26a4d84019a0c9ee7f48224832361cdd82c2",
    ("video-k50", "zeros"):
        "9f4797e58b743ad5dd4174c26188274c3eb872e67d1a8a7a7f21422ad39200af",
    ("webbase-k50", "positive"):
        "94363fa33a1695a86b494ac8f6ea89ac6fe9bcdf534a8858fefad2b1809654e7",
    ("webbase-k50", "zeros"):
        "b27b23f0d89a6e01ea7e7e982cc511ddc124fb28f9eadacd9168828a1788b62a",
}


@pytest.mark.parametrize("config,w0", sorted(SERIAL_DIGESTS))
def test_serial_cells_inputs_are_unchanged(config, w0):
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    cfg.update(TINY[cfg["storage"]])
    out = gen.make_inputs(cfg, {"w0": w0}, 2**31 + 5, CPU)
    h = hashlib.sha256()
    for key in sorted(out):
        h.update(key.encode())
        h.update(str(out[key].dtype).encode())
        h.update(out[key].contiguous().numpy().tobytes())
    assert h.hexdigest() == SERIAL_DIGESTS[config, w0]


# ---------------------------------------------------------------------------
# Cells, counts
# ---------------------------------------------------------------------------

def test_accepted_cells_run_in_process_and_a_grid_must_match_its_chips(
        tmp_path):
    for name in json.loads((ROOT / "BENCHMARK.json").read_text()) \
            ["workloads"]:
        assert not harness.Cell(ROOT, name["name"]).ranked
    root = grid_checkout(tmp_path)
    assert harness.Cell(root, "wb2x2-mu").ranked
    assert harness.Cell(root, "wb1x1-mu").ranked
    assert not harness.Cell(root, "wbser-mu").ranked
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if w["name"] == "wb2x2-mu":
            w["chips"] = 1
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError):
        harness.Cell(root, "wb2x2-mu")


def test_least_time_on_p_chips_is_the_whole_count_over_p():
    one = counts.least_by_group(TILED, "mu")
    four = counts.least_by_group(TILED, "mu", 4)
    assert four == {g: v / 4 for g, v in one.items()}


# ---------------------------------------------------------------------------
# The reference split across ranks, and the window
# ---------------------------------------------------------------------------

def _split_reference(device, cfg, traffic, iters, dtype, out_dir):
    r = ranks.Ranks(cfg, device)
    inputs = gen.make_inputs(cfg, traffic, SEED, device, r.shape, r.block)
    r.localize(inputs)
    ref = r.segment(r.products(inputs, dtype=dtype), cfg, traffic, SEED,
                    iters)
    torch.save(ref, Path(out_dir) / f"rank{r.rank}.pt")
    return {"rels": ref["rels"]}


#: (rule, dtype): in float64 the split's sums in another order read as
#: nothing, and a wrong group or offset as a gap of order 1; in fp32, MU
#: (HALS's W sweep subtracts nearly equal terms, which amplifies the
#: reordering past 1e-6 within an iteration)
SPLIT_RUNS = [("mu", torch.float32), ("mu", torch.float64),
              ("hals", torch.float64), ("bpp", torch.float64)]


@pytest.mark.parametrize("rule,dtype", SPLIT_RUNS)
def test_split_reference_agrees_with_the_one_process_reference(tmp_path,
                                                               rule, dtype):
    cfg = {**TILED, "grid": [2, 2]}
    traffic = {**TRAFFIC["mu"], "rule": rule}
    iters = 3
    got = launch.ranks(4, _split_reference,
                       (cfg, traffic, iters, dtype, str(tmp_path)),
                       device_type="cpu", timeout_s=300)
    assert got is not None
    inputs = gen.make_inputs(cfg, traffic, SEED, CPU)
    W, Ht, rels = reference.segment(
        harness.products(cfg, inputs, dtype=dtype), rule, inputs["W0"],
        inputs["H0"], iters)
    pr, pc = cfg["grid"]
    wr, hr = cfg["m"] // 4, cfg["n"] // 4
    for rank in range(4):
        i, j = divmod(rank, pc)
        part = torch.load(tmp_path / f"rank{rank}.pt")
        w0, h0 = (i * pc + j) * wr, (j * pr + i) * hr
        assert (part["W"] - W[w0:w0 + wr]).abs().max() <= \
            1e-6 * W.abs().max()
        assert (part["Ht"] - Ht[h0:h0 + hr]).abs().max() <= \
            1e-6 * Ht.abs().max()
        assert part["rels"] == got["rels"]
    assert max(abs(a - b) / b for a, b in zip(got["rels"], rels)) <= 1e-6


class _Segments:
    """Stands in for ``harness.Segments``: rank 1's segments take four
    times rank 0's."""

    iters = 3

    def __init__(self, rank):
        self.pause = 0.01 * (4 if rank == 1 else 1)

    def run(self):
        time.sleep(self.pause)
        return torch.zeros(self.iters)


def _window_segments(device):
    r = ranks.Ranks({"grid": [1, 2], "m": 2, "n": 2}, device)
    w = harness.window(_Segments(r.rank), 0.1, device, r)
    return {"segments": r.gather([w["segments"]]),
            "window_s": w["window_s"], "nonfinite": w["nonfinite"]}


def test_every_rank_runs_as_many_segments_as_rank_0_decides():
    got = launch.ranks(2, _window_segments, device_type="cpu", timeout_s=120)
    (a,), (b,) = got["segments"]
    assert a == b >= 1 and got["window_s"] >= 0.1 and got["nonfinite"] == 0


# ---------------------------------------------------------------------------
# Runs of a grid cell through the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule", ["mu", "hals"])
def test_faun_grid_cell_is_judged_correct(tmp_path, rule):
    root = grid_checkout(tmp_path)
    r, _, stdout = run_ranked(root, f"wb2x2-{rule}", trace=True)
    assert r["correct"] is True and r["device"]["count"] == 4
    assert list(r)[-1] == "checks" and json.loads(stdout) == r
    assert {"mm_ms", "luc_ms", "gram_ms", "iter_mfu"} <= set(r["metrics"])
    one, _, _ = run_ranked(root, f"wb1x1-{rule}")
    serial = run_tiny(root, f"wbser-{rule}", SEED)
    assert one["correct"] is True and serial["correct"] is True
    for name, c in one["checks"].items():        # faun at 1 × 1 as serial
        assert c["value"] <= 2 * serial["checks"][name]["value"] + 1e-12


def _control(device, cfg, traffic, limits, seeds):
    r = ranks.Ranks(cfg, device)
    iters = harness.check_iters(traffic)
    fails = 0
    for seed in seeds:
        inputs = gen.make_inputs(cfg, traffic, seed, device, r.shape,
                                 r.block)
        r.localize(inputs)
        ref = r.segment(r.products(inputs), cfg, traffic, seed, iters)
        ctl = r.segment(r.products(inputs, tf32=True), cfg, traffic, seed,
                        iters)
        nums = r.judge_outputs(inputs, ctl, ref)
        fails += not judge.decide(nums, limits)[0]
    return {"fails": fails}


@pytest.mark.parametrize("rule", ["mu", "hals"])
def test_control_in_tf32_across_ranks_is_not_correct(rule):
    cfg = {**TILED, "grid": [2, 2]}
    limits = json.loads((HERE / "workloads" / f"{LIMITS[rule]}.json")
                        .read_text())["limits"]
    got = launch.ranks(4, _control, (cfg, TRAFFIC[rule], limits,
                                     [11, 12, 13]),
                       device_type="cpu", timeout_s=300)
    assert got == {"fails": 3}


#: code appended to a checkout's ``harness.py`` (each rebinds a function
#: that ``run`` calls)
PLANTED = {
    # one rank's rows of W out of order
    "permuted": """
_program_output = program_output
def program_output(seg, iters):
    import torch.distributed as dist
    out = _program_output(seg, iters)
    if dist.get_rank() == 1:
        out["W"] = out["W"].flip(0)
    return out
""",
    # a rank that raises before its window
    "raises": """
_run = run
def run(*args):
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_rank() == 1:
        raise RuntimeError("planted")
    return _run(*args)
""",
    # a rank that never reaches its collectives
    "hangs": """
_run = run
def run(*args):
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_rank() == 1:
        time.sleep(3600)
    return _run(*args)
""",
}


def _planted(tmp_path, fault) -> Path:
    root = grid_checkout(tmp_path)
    with open(root / "perfbench" / "harness.py", "a") as f:
        f.write(PLANTED[fault])
    return root


@pytest.mark.parametrize("rule", ["mu", "hals"])
def test_one_rank_with_its_rows_permuted_is_not_correct(tmp_path, rule):
    r, _, _ = run_ranked(_planted(tmp_path, "permuted"), f"wb2x2-{rule}")
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault,timeout_s", [("raises", 120.0),
                                             ("hangs", 20.0)])
def test_a_failed_rank_ends_the_run_with_no_result(tmp_path, fault,
                                                   timeout_s):
    r, seconds, stdout = run_ranked(_planted(tmp_path, fault), "wb2x2-mu",
                                    timeout_s=timeout_s)
    assert r is None and stdout.strip() == ""
    assert seconds < timeout_s + 45


def test_calibrate_reads_a_grid_cell_and_its_control(tmp_path):
    root = grid_checkout(tmp_path)
    out = subprocess.run(
        [sys.executable, "-W", "ignore", str(root / "perfbench" /
                                             "calibrate.py"),
         "--workload", "wb2x2-mu", "--seeds", "21", "22",
         "--control-seeds", "22", "--device", "cpu"],
        capture_output=True, text=True, check=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    rows = [json.loads(line) for line in out.stdout.strip().splitlines()]
    assert [r["seed"] for r in rows] == [21, 22] and "control" in rows[1]
    limits = json.loads((HERE / "workloads" / "webbase-mu.json")
                        .read_text())["limits"]
    assert all(judge.decide(r["program"], limits)[0] for r in rows)
    assert not judge.decide(rows[1]["control"], limits)[0]
