"""``lower_step`` of the port's engine and schedules: one iteration run on
fake tensors of a rank's blocks and counted (``roofline/counts.py``).  The
port's cases of tests/test_engine.py's lowering smoke tests, of
tests/distributed_checks.py's collective checks and of
tests/engine_distributed_checks.py's wire checks, on fake worlds (one
process, the ``fake`` backend); then one record against the wire log of a
real faun 2 × 2 iteration on four gloo ranks, and ``lower_step`` called by
rank 0 alone on a real group."""

import os
import tempfile
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import faun, gspmd, naive
from repro_torch.core.engine import NMFSolver
from repro_torch.roofline import counts
from repro_torch.util import dist as rdist

M, N, K = 96, 64, 6
NNZ = 1_500


@pytest.fixture
def fake_world():
    """``fake_world(n)`` makes a fake world of n ranks for one test (and
    destroys it after)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized(), "a default process group exists"

    def make(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    try:
        yield make
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _sig(rec):
    return [(c.op, c.dtype, tuple(c.shape), c.group_size)
            for c in rec.collectives]


# ------------------------------------------------------------- serial -----

def test_serial_lower_step_lists_its_matmuls():
    rec = NMFSolver(4, algo="mu", device="cpu").lower_step(32, 24)
    assert "aten::mm" in rec.as_text()
    assert rec.collectives == [] and rec.kernels == []
    # the two products and three Grams, as counted
    assert rec.dot_flops >= 2 * 2 * 32 * 24 * 4


def test_serial_sparse_lower_step_lists_its_scatter_add():
    rec = NMFSolver(4, algo="mu", backend="sparse",
                    device="cpu").lower_step(32, 24, nnz=40)
    assert "index_add" in rec.as_text()


@pytest.mark.parametrize("algo,luc", [("mu", {"mu_update": 2}),
                                      ("hals", {"hals_sweep": 1,
                                                "hals_sweep_norm": 1}),
                                      ("bpp", {}),
                                      ("amu", {"mu_update": 8}),
                                      ("ahals", {"hals_sweep": 4,
                                                 "hals_sweep_norm": 4})])
def test_serial_cuda_lower_step_counts_the_kernels(algo, luc):
    """The main path (backend "cuda", the card stood in for) records one
    call per launch a live iteration makes; the accelerated rules run
    their whole inner budget (4 sweeps a half here)."""
    with counts.stand_in_card():
        rec = NMFSolver(K, algo=algo, backend="cuda").lower_step(M, N)
    assert dict(rec.kernel_calls()) == {"gram": 3, "ts_matmul": 1,
                                        "ts_matmul_t": 1, **luc}
    roof = rec.roofline()
    assert roof["step_lower_bound_s"] > 0
    if algo == "bpp":
        assert [k[0] for k in rec.modelled] == ["bpp_solve"]
    else:
        assert not rec.modelled


def test_sparse_cuda_lower_step_uses_the_spmm_kernels():
    from repro_torch.backends import SparseOps
    with counts.stand_in_card():
        rec = NMFSolver(K, algo="mu", backend="sparse").lower_step(
            M, N, nnz=NNZ)
        srt = NMFSolver(K, algo="mu", backend=SparseOps(
            spmm_impl="sorted")).lower_step(M, N, nnz=NNZ)
    assert rec.kernel_calls()["spmm"] == 2
    assert srt.kernel_calls()["spmm_sorted"] == 2


# ----------------------------------------------- the paper's collectives --

def test_faun_lowering_has_the_papers_collectives(fake_world):
    fake_world(8)
    rec = faun.lower_step(faun.make_faun_grid(4, 2), 64, 32, 4, algo="mu",
                          device="cpu")
    st = counts.collective_stats(rec)
    assert st.counts["all-gather"] >= 2, st.counts       # lines 5, 11
    assert st.counts["all-reduce"] >= 2, st.counts       # lines 4, 10
    assert st.counts["reduce-scatter"] >= 2, st.counts   # lines 7, 13


def test_faun_grid_shape_tradeoff(fake_world):
    """Paper Fig 7: for square-ish A the 2D grid moves less than both 1D
    grids."""
    fake_world(8)
    m, n, k = 256, 256, 8
    vols = {}
    for pr, pc in [(8, 1), (4, 2), (2, 4), (1, 8)]:
        rec = faun.lower_step(faun.make_faun_grid(pr, pc), m, n, k,
                              algo="mu", device="cpu")
        vols[(pr, pc)] = counts.collective_stats(rec).total_wire_bytes
    assert min(vols[(4, 2)], vols[(2, 4)]) < vols[(8, 1)], vols
    assert min(vols[(4, 2)], vols[(2, 4)]) < vols[(1, 8)], vols


def test_sparse_faun_never_gathers_A(fake_world):
    fake_world(4)
    solver = NMFSolver(K, algo="mu", schedule="faun", backend="sparse",
                       grid=faun.make_faun_grid(2, 2), device="cpu")
    st = counts.collective_stats(solver.lower_step(M, N, nnz=NNZ))
    # the paper's six collectives, nothing else moving data
    assert st.counts["all-gather"] == 2, st.counts
    assert st.counts["reduce-scatter"] == 2, st.counts
    assert st.counts["all-to-all"] == 0, st.counts
    assert st.wire_bytes["all-gather"] <= (M + N) * K * 4, st.wire_bytes
    assert st.wire_bytes["all-gather"] < NNZ * 4, st.wire_bytes


def test_sparse_naive_never_gathers_A(fake_world):
    fake_world(8)
    solver = NMFSolver(K, algo="mu", schedule="naive", backend="sparse",
                       device="cpu")
    st = counts.collective_stats(solver.lower_step(M, N, nnz=NNZ))
    # Algorithm 2's waste is the two FULL-factor gathers, k-width still
    assert st.counts["all-gather"] == 2, st.counts
    assert st.counts["all-to-all"] == 0, st.counts
    assert st.bytes_moved["all-gather"] <= (M + N) * K * 4, st.bytes_moved
    assert st.bytes_moved["all-gather"] < NNZ * 4, st.bytes_moved


def test_sparse_gspmd_keeps_A_local(fake_world):
    """DTensor keeps the nnz-sharded triplets local: only k-width factor
    gathers (and Grams), no all-to-all.  Its redistributions gather the
    factors in two steps over (pr, pc), so the gathered bytes exceed the
    reference's (M + N)·K·4 bound (XLA's choice), but never reach A's."""
    fake_world(8)
    solver = NMFSolver(K, algo="mu", schedule="gspmd", backend="sparse",
                       grid=faun.make_faun_grid(4, 2), device="cpu")
    rec = solver.lower_step(M, N, nnz=NNZ)
    st = counts.collective_stats(rec)
    assert st.counts["all-to-all"] == 0, st.counts
    assert st.bytes_moved["all-gather"] < NNZ * 4, st.bytes_moved
    for op, _, dims in counts.collective_dtype_stats(rec):
        assert len(dims) <= 1 or dims[-1] == K, (op, dims)
    ar_bound = 2 * (M + N) * K * 4 + 8 * K * K * 4
    assert st.bytes_moved["all-reduce"] <= ar_bound, st.bytes_moved


def test_compressed_faun_puts_only_int8_panels_on_the_wire(fake_world):
    """In the compressed faun step the panel payloads are s8 (gathers,
    all-to-all scatters) and s32 (Gram reductions); f32 only as 1-D scale
    sidecars, the k × k error-byproduct Gram and the error scalar."""
    fake_world(8)
    solver = NMFSolver(K, algo="mu", schedule="faun",
                       grid=faun.make_faun_grid(4, 2),
                       panel_compression="int8", device="cpu")
    entries = counts.collective_dtype_stats(solver.lower_step(M, N))
    ops_by_dtype = {(op, dt) for op, dt, _ in entries}
    assert ("all-gather", "s8") in ops_by_dtype, sorted(ops_by_dtype)
    assert ("all-to-all", "s8") in ops_by_dtype, sorted(ops_by_dtype)
    assert ("all-reduce", "s32") in ops_by_dtype, sorted(ops_by_dtype)
    assert not any(op == "reduce-scatter" for op, _, _ in entries), entries
    for op, dt, dims in entries:
        if dt in ("s8", "s32"):
            continue
        assert dt == "f32", (op, dt, dims)
        assert len(dims) <= 1 or tuple(dims) == (K, K), (op, dt, dims)


def test_bpp_record_models_its_solve(fake_world):
    """BPP's pivoting reads its data: the record counts what surrounds the
    solve, adds the solve's cost-model FLOPs as modelled, and puts the same
    collectives on the wire as mu."""
    fake_world(4)
    grid = faun.make_faun_grid(2, 2)
    mu = faun.lower_step(grid, M, N, K, algo="mu", device="cpu")
    bpp = faun.lower_step(grid, M, N, K, algo="bpp", device="cpu")
    assert _sig(bpp) == _sig(mu)
    p = 4
    per_col = K ** 3 / 3.0 + 2.0 * K * K
    assert dict(bpp.modelled) == {("bpp_solve", "float32"):
                                  (M / p + N / p) * per_col}
    assert "modelled bpp_solve" in bpp.as_text()


def test_gspmd_and_naive_lower_step_wrappers(fake_world):
    fake_world(4)
    grid = faun.make_faun_grid(2, 2)
    g = gspmd.lower_step(grid, M, N, K, device="cpu")
    nv = naive.lower_step(None, M, N, K, algo="mu", device="cpu")
    # every rank's local products: two of (m/p)·n·k or m·(n/p)·k each
    assert g.dot_flops >= 2 * 2 * M * N * K / 4
    assert counts.collective_stats(nv).counts["all-gather"] == 2


# ------------------------------------------------- against a live run ----

def _live_rank(out):
    """Rank body: the wire log of one real faun 2 × 2 mu iteration, then
    ``lower_step`` on rank 0 alone (the others wait at a barrier)."""
    from repro_torch.util.wire import record_wire
    rng = np.random.default_rng(0)
    A = rng.uniform(size=(M, N)).astype(np.float32)
    grid = faun.make_faun_grid(2, 2)
    solver = NMFSolver(K, algo="mu", schedule="faun", grid=grid,
                       backend="dense", device="cpu")
    rs = solver.prepare_state(A, seed=0)
    with record_wire() as log:
        solver.run_segment(rs, 1)
    live = [(c.op, c.dtype, tuple(c.shape), c.group_size) for c in log]
    alone = None
    if dist.get_rank() == 0:
        box = {}

        def run():
            t0 = time.perf_counter()
            box["rec"] = faun.lower_step(grid, M, N, K, algo="mu",
                                         device="cpu")
            box["g"] = gspmd.lower_step(grid, M, N, K, device="cpu")
            box["s"] = time.perf_counter() - t0

        th = threading.Thread(target=run, daemon=True)
        th.start()
        th.join(60)
        alone = {"returned": not th.is_alive(), "s": box.get("s"),
                 "sig": _sig(box["rec"]) if "rec" in box else None,
                 "gspmd": len(box["g"].collectives) if "g" in box else 0}
    dist.barrier()
    if dist.get_rank() == 0:
        torch.save({"live": live, "alone": alone}, out)


@pytest.fixture(scope="module")
def live():
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "live.pt")
        rdist.spawn(_live_rank, 4, out, device="cpu")
        return torch.load(out, weights_only=False)


def test_record_equals_the_live_wire_log(live, fake_world):
    fake_world(4)
    rec = faun.lower_step(faun.make_faun_grid(2, 2), M, N, K, algo="mu",
                          device="cpu")
    assert _sig(rec) == live["live"]


def test_lower_step_alone_on_a_real_group_sends_nothing(live):
    alone = live["alone"]
    assert alone["returned"], "lower_step waited on the other ranks"
    assert alone["sig"] == live["live"]
    assert alone["gspmd"] > 0
