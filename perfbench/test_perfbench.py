"""CPU tests of the benchmark harness, at tiny sizes.

    python -m pytest -p no:cacheprovider perfbench/test_perfbench.py

Each test that runs a cell copies the benchmark (``BENCHMARK.json`` and
``perfbench/``) into a temporary checkout and shrinks the configurations
there, so the cells run through the harness as the chip runs them, with
the port's plain PyTorch versions standing in for its kernels.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
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
import reference  # noqa: E402

CPU = torch.device("cpu")
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
TINY = {"dense": {"m": 600, "n": 96, "k": 8},
        "sparse": {"m": 1024, "n": 1024, "k": 8, "nnz": 8840}}
#: the keys of a result line, in order
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_checkout(tmp: Path) -> Path:
    """A copy of the benchmark whose configurations are cut to ``TINY``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(HERE, tmp / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for path in (tmp / "perfbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY[cfg["storage"]])
        path.write_text(json.dumps(cfg))
    return tmp


def run_tiny(root: Path, cell: str, seed: int = 2**31 + 7,
             trace: bool = False) -> dict:
    """One run of ``cell`` on the CPU through ``root``'s own harness."""
    code = f"""
import json, sys, time
from pathlib import Path
sys.path.insert(0, {str(ROOT / 'src')!r})
sys.path.insert(0, {str(root / 'perfbench')!r})
import torch, harness
r = harness.run(Path({str(root)!r}), {cell!r}, {seed}, 0.2, {trace},
                torch.device('cpu'), time.perf_counter())
print(json.dumps(r))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# Inputs, counts and the reference
# ---------------------------------------------------------------------------

def test_generators_repeat_for_a_seed_and_differ_across_seeds():
    for storage in ("dense", "sparse"):
        cfg = {**json.loads((HERE / "configs" / (
            "video-k50.json" if storage == "dense" else "webbase-k50.json"))
            .read_text()), **TINY[storage]}
        traffic = {"rule": "mu", "segment_iters": 2, "w0": "positive"}
        a = gen.make_inputs(cfg, traffic, 2**31 + 5, CPU)
        b = gen.make_inputs(cfg, traffic, 2**31 + 5, CPU)
        c = gen.make_inputs(cfg, traffic, 2**31 + 6, CPU)
        for key in a:
            assert torch.equal(a[key], b[key]), key
        assert not torch.equal(a["H0"], c["H0"])
        if storage == "sparse":
            idx = a["indices"][0] * cfg["n"] + a["indices"][1]
            assert idx.numel() == cfg["nnz"]
            assert bool((idx[1:] > idx[:-1]).all())     # distinct, row-major
            assert bool((a["values"] > 0).all())
        assert bool((a["W0"] >= 0.1).all())


def test_counts_match_hand_worked_shapes():
    # A 4 × 3 · B 3 × 2: 2·4·3·2 FLOPs; (12 + 6 + 8) · 4 bytes
    assert counts.dense_product(4, 3, 2) == (48.0, 104.0)
    # 5 nonzeros of a 4 × 3 matrix · B (3, 2): 20 FLOPs; 5·8 + (3 + 4)·2·4
    assert counts.sparse_product(5, 3, 4, 2) == (20.0, 96.0)
    # Gram of X (10, 2): 2·10·4 FLOPs; (20 + 4)·4 bytes
    assert counts.gram(10, 2) == (80.0, 96.0)
    assert counts.luc("mu", 10, 2) == (160.0, 256.0)
    assert counts.luc("bpp", 10, 2) is None
    assert counts.luc_floor(10, 2) == (0.0, 176.0)
    assert counts.least_ms(counts.PEAK_TF32_FLOPS, 0) == 1e3
    assert counts.least_ms(0, counts.PEAK_HBM_BYTES) == 1e3
    # Video: each product is bound by reading A's 56.04 GB
    cfg = {"m": 1_013_400, "n": 13_824, "k": 50, "storage": "dense"}
    least = counts.least_by_group(cfg, "mu")
    assert least["mm"] == pytest.approx(2 * 56.2466e9 / 3.35e12 * 1e3,
                                        rel=1e-4)
    assert counts.least_by_group(cfg, "bpp")["luc"] is None
    assert least["iteration"] > sum(least[g] for g in ("mm", "gram", "luc"))


def _mu_f64(A, W, H, iters):
    eps = reference.EPS
    W, H, rels = W.copy(), H.copy(), []
    for _ in range(iters):
        W = W * (A @ H.T) / (W @ (H @ H.T) + eps)
        H = H * (W.T @ A) / ((W.T @ W) @ H + eps)
        rels.append(np.linalg.norm(A - W @ H) / np.linalg.norm(A))
    return W, H, rels


@pytest.mark.parametrize("storage", ["dense", "sparse"])
def test_reference_agrees_with_float64(storage):
    g = torch.Generator().manual_seed(3)
    m, n, k = 64, 48, 5
    W0 = 0.1 + 0.9 * torch.rand((m, k), generator=g)
    H0 = torch.rand((k, n), generator=g)
    if storage == "dense":
        A = torch.rand((m, n), generator=g)
        P = reference.Products(A=A)
    else:
        indices, values = gen.erdos_renyi(g, m, n, 600)
        A = torch.zeros((m, n))
        A[indices[0], indices[1]] = values
        P = reference.Products(indices=indices, values=values, shape=(m, n))
    W, Ht, rels = reference.segment(P, "mu", W0, H0, 5)
    W64, H64, rels64 = _mu_f64(A.double().numpy(), W0.double().numpy(),
                               H0.double().numpy(), 5)
    assert np.allclose(W.numpy(), W64, rtol=1e-4, atol=1e-6)
    assert np.allclose(Ht.numpy(), H64.T, rtol=1e-4, atol=1e-6)
    assert np.allclose(rels, rels64, rtol=1e-4)


def test_bpp_reference_solves_nnls_exactly():
    g = torch.Generator().manual_seed(4)
    C = torch.randn((40, 6), generator=g, dtype=torch.float64)
    B = torch.randn((40, 30), generator=g, dtype=torch.float64)
    P = reference.Products(A=torch.zeros(1, 1), dtype=torch.float64)
    X = reference.bpp(P, C.T @ C, (C.T @ B).T)
    G, R = C.T @ C, (C.T @ B).T
    grad = X @ G - R                          # KKT: x ≥ 0, ∇ ≥ 0, x ⊙ ∇ = 0
    assert bool((X >= 0).all())
    assert float(grad.min()) > -1e-9
    assert float((X * grad).abs().max()) < 1e-9


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 1.0 + 2.0**-10,
                      -3.0 - 2.0**-12])
    got = reference.to_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2.0**-9, 1.0 + 2.0**-10, -3.0]


def test_judge_row_gap_counts_one_altered_answer():
    X = torch.ones((1000, 4))
    Y = X.clone()
    Y[7, 2] = 1.1
    nums = judge.numbers({"W": Y, "Ht": X, "rels": [0.5]},
                         {"W": X, "Ht": X, "rels": [0.5]}, 0.5)
    assert nums["w_row"] == pytest.approx(0.05)
    assert nums["h_row"] == 0.0 and nums["rel_traj"] == 0.0
    ok, checks = judge.decide(nums, {"w_row": 0.01})
    assert not ok and checks["w_row"]["limit"] == 0.01
    assert not judge.decide(nums, {})[0]


# ---------------------------------------------------------------------------
# Runs of the cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_result_line_has_the_contract_keys(tmp_path, cell):
    root = tiny_checkout(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    r = run_tiny(root, cell)
    assert list(r)[:5] == RESULT_KEYS and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    want = {m["name"] for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])} - {"peak_gb"}
    assert want <= set(r["metrics"])           # no peak on the CPU
    assert set(r["checks"]) == set(json.loads(
        (HERE / "workloads" / f"{cell}.json").read_text())["limits"])
    t = run_tiny(root, cell, trace=True)
    assert list(t)[-1] == "checks" and "breakdown" in t
    assert {"busy_s", "window_s"} <= set(t["device"])
    assert {"mm_ms", "luc_ms", "gram_ms", "prepare_s"} <= set(t["metrics"])


def test_run_refuses_without_a_card():
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin"},
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_harness_loads_no_jax_and_no_jax_package():
    code = f"""
import sys
sys.path.insert(0, {str(ROOT / 'src')!r}); sys.path.insert(0, {str(HERE)!r})
import harness, calibrate, run
from repro_torch.core import engine
from repro_torch.obs import phases
from repro_torch.backends import SparseOps
for p in sorted((harness.HERE / "metrics").glob("*.py")):
    harness.reader(p.stem)
print(run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_new_files_are_found_by_name_without_editing(tmp_path):
    root = tiny_checkout(tmp_path)
    pb = root / "perfbench"
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in pb.rglob("*") if p.is_file()}
    cfg = json.loads((pb / "configs" / "video-k50.json").read_text())
    cfg.update(name="video-k12", k=12)
    (pb / "configs" / "video-k12.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "mu-seg3.json").write_text(json.dumps(
        {"rule": "mu", "segment_iters": 3, "w0": "positive"}))
    (pb / "workloads" / "video-k12-mu.json").write_text(json.dumps(
        {"limits": {"w_row": 1e-3}}))
    (pb / "metrics" / "segments_seen.py").write_text(
        "def read(rec):\n    return rec['segments'] if 'trace' in rec "
        "else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "video-k12", "source": "test",
                             "file": "perfbench/configs/video-k12.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "video-k12-mu", "config": "video-k12",
                               "traffic": "mu-seg3", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "segments_seen", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "iter_ms",
                               "workloads": ["video-k12-mu"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run_tiny(root, "video-k12-mu", trace=True)
    assert r["correct"] is True and r["metrics"]["segments_seen"]["value"] >= 1
    assert list(r["checks"]) == ["w_row"]
    for p, digest in before.items():
        assert hashlib.sha256(p.read_bytes()).hexdigest() == digest, p


# ---------------------------------------------------------------------------
# The control and the faults: each must come out not correct
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_control_in_tf32_is_not_correct(cell):
    c = harness.Cell(ROOT, cell)
    cfg = {**c.cfg, **TINY[c.cfg["storage"]]}
    fails = 0
    for seed in (11, 12, 13):
        inputs = gen.make_inputs(cfg, c.traffic, seed, CPU)
        ref = harness.reference_segment(cfg, c.traffic, inputs)
        ctl = harness.reference_segment(cfg, c.traffic, inputs, tf32=True)
        nums = harness.judge_outputs(cfg, c.traffic, inputs, ctl, ref)
        fails += not judge.decide(nums, c.limits)[0]
    assert fails == 3


FAULTS = {
    # a step that returns its state unchanged
    "unchanged": """
from repro_torch.core import engine
engine.NMFSolver._step = lambda self, rs, W, Ht, state: (
    W, Ht, rs.normA_sq * 0.25, state)
""",
    # half of the contraction left out, the rest doubled (a sampled product)
    "half": """
from repro_torch.core import aunmf
step = aunmf.aunmf_step_rule
def halved(A, W, Ht, rule, state, normA_sq, *, mm, mm_t, gram, **kw):
    def mm2(A, B):
        out = mm(A, B)
        keep = torch.arange(out.shape[0], device=out.device) % 2 == 0
        return 2 * out * keep[:, None]
    return step(A, W, Ht, rule, state, normA_sq, mm=mm2, mm_t=mm_t,
                gram=gram, **kw)
aunmf.aunmf_step_rule = halved
from repro_torch.core import engine
engine.aunmf_step_rule = halved
""",
    # one answer altered where it is produced
    "altered": """
from repro_torch.core import rules
upd = rules.UpdateRule.update_h
def altered(self, G, R, X, state=None, **kw):
    X, state = upd(self, G, R, X, state, **kw)
    X = X.clone()
    X[3] = 2 * X[3] + 0.1
    return X, state
rules.UpdateRule.update_h = altered
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_program_is_not_correct(tmp_path, cell, fault):
    root = tiny_checkout(tmp_path)
    code = f"""
import json, sys, time
from pathlib import Path
sys.path.insert(0, {str(ROOT / 'src')!r})
sys.path.insert(0, {str(root / 'perfbench')!r})
import torch, harness
{FAULTS[fault]}
r = harness.run(Path({str(root)!r}), {cell!r}, 77, 0.2, False,
                torch.device('cpu'), time.perf_counter())
print(json.dumps(r))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=600)
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is False, r["checks"]


def test_window_counts_whole_segments():
    class Fake:
        iters = 4

        def run(self):
            time.sleep(0.01)
            return torch.zeros(4)

    w = harness.window(Fake(), 0.05, CPU)
    assert w["iters"] == 4 * w["segments"] and w["window_s"] >= 0.05
