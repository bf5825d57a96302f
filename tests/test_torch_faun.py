"""The port's distributed schedules on gloo ranks on the CPU: ``faun``
(Algorithm 3) on pr × pc grids and ``naive`` (Algorithm 2) on 1-D groups,
held against the JAX package's serial engine on the same numpy A and the
same explicit W0/H0 (the contract the reference's own
tests/engine_distributed_checks.py holds its schedules to).

Each grid is spawned once per module (``util.dist.spawn``, gloo, a
``file://`` rendezvous): its ranks run every algo × backend and write
their results to a temporary directory, which the parametrised cases read.
The rank bodies are top-level functions of this module, and this module
imports no JAX at its top: the spawned ranks never import JAX.
"""

import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.backends import CudaOps, DenseOps, SparseOps
from repro_torch.core import blocksparse, faun, naive
from repro_torch.core.engine import NMFSolver
from repro_torch.core.faun import make_faun_grid
from repro_torch.util import dist as rdist

M, N, K = 96, 64, 6
ITERS = 3
ALGOS = ["mu", "hals", "bpp", "amu", "ahals"]
# "scatter" / "sorted": the sparse backend's two CPU lowerings
BACKENDS = ["cuda", "dense", "scatter", "sorted"]
GRIDS = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (1, 4)]
NAIVE_GRIDS = {(1, 1): 1, (1, 2): 2, (2, 2): 4}     # the naive group's p
# adaptive runs on the 2×2 grid: (name, algo, problem seed, solver kwargs);
# bpp's tol is set from the JAX serial run (``_tol_case``)
STALL = dict(max_iters=40, stall_iters=2, stall_tol=2e-3)


def _problem(seed=0, m=M, n=N, k=K, noise=0.5):
    """Low rank plus noise (tests/test_torch_engine.py's problem)."""
    rng = np.random.default_rng(seed)
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + noise * rng.uniform(size=(m, n))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    return A, W0, H0


def _backend(name):
    return (SparseOps(spmm_impl=name) if name in ("scatter", "sorted")
            else name)


def _assert_scaled(got, want, atol=1e-4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


# ---------------------------------------------------------------------------
# Rank bodies (run in the spawned processes)
# ---------------------------------------------------------------------------

def _save(out, tag, res):
    st = res.extras["rule_state"] or {}
    np.savez(os.path.join(out, f"{tag}_r{dist.get_rank()}.npz"),
             W=res.W.numpy(), H=res.H.numpy(), rels=res.rel_errors.numpy(),
             iters=res.iters, inner_w=st.get("inner_w", -1),
             inner_h=st.get("inner_h", -1))


def _grid_rank(out, pr, pc, tol):
    A, W0, H0 = _problem()
    grid = make_faun_grid(pr, pc)
    np.save(os.path.join(out, f"cell_{pr}x{pc}_r{dist.get_rank()}.npy"),
            np.array([grid.i, grid.j]))
    for algo in ALGOS:
        for b in BACKENDS:
            kw = dict(algo=algo, backend=_backend(b), device="cpu",
                      max_iters=ITERS)
            res = NMFSolver(K, schedule="faun", grid=grid, **kw).fit(
                A, W0=W0, H0=H0)
            _save(out, f"faun_{pr}x{pc}_{algo}_{b}", res)
            if (pr, pc) in NAIVE_GRIDS:
                res = NMFSolver(K, schedule="naive", **kw).fit(
                    A, W0=W0, H0=H0)
                _save(out, f"naive_{pr * pc}_{algo}_{b}", res)
            if (pr, pc) == (1, 1):
                res = NMFSolver(K, **kw).fit(A, W0=W0, H0=H0)
                _save(out, f"serial_{algo}_{b}", res)
    if (pr, pc) != (2, 2):
        return
    # adaptive stopping: every rank must stop at the same iteration
    for name, algo, seed, kw in _adaptive_cases(tol):
        A, W0, H0 = _problem(seed)
        for schedule in ("faun", "naive"):
            res = NMFSolver(K, algo=algo, schedule=schedule, device="cpu",
                            **kw).fit(A, W0=W0, H0=H0)
            _save(out, f"{schedule}_adaptive_{name}", res)
    # a result of the grid, published for the JAX package to load
    A, W0, H0 = _problem()
    res = NMFSolver(K, algo="bpp", schedule="faun", device="cpu",
                    max_iters=ITERS).fit(A, W0=W0, H0=H0)
    if dist.get_rank() == 0:
        res.save_artifact(os.path.join(out, "artifact"))
        _save(out, "faun_artifact", res)
    # the legacy fit wrappers: the same runs as NMFSolver's
    _save(out, "faun_fit", faun.fit(A, K, grid=make_faun_grid(2, 2),
                                    algo="hals", iters=ITERS, W0=W0, H0=H0,
                                    device="cpu"))
    _save(out, "naive_fit", naive.fit(A, K, algo="hals", iters=ITERS, W0=W0,
                                      H0=H0, device="cpu"))


def _adaptive_cases(tol):
    return [("tol", "bpp", 2, dict(max_iters=50, tol=tol)),
            ("tol_ahals", "ahals", 2, dict(max_iters=50, tol=tol)),
            ("stall", "mu", 3, STALL)]


def _raising_rank():
    raise RuntimeError("rank failed on purpose")


# ---------------------------------------------------------------------------
# The JAX side (imported only in this process)
# ---------------------------------------------------------------------------

@functools.cache
def _jax_serial(algo, seed=0, **kw):
    import jax.numpy as jnp
    from repro.core.engine import NMFSolver as JaxSolver
    A, W0, H0 = _problem(seed)
    kw.setdefault("max_iters", ITERS)
    res = JaxSolver(K, algo=algo, backend="dense", **kw).fit(
        jnp.asarray(A), W0=jnp.asarray(W0), H0=jnp.asarray(H0))
    st = res.extras["rule_state"]
    return {"W": np.asarray(res.W), "H": np.asarray(res.H),
            "rels": np.asarray(res.rel_errors), "iters": int(res.iters),
            "inner_w": -1 if st is None else int(st["inner_w"]),
            "inner_h": -1 if st is None else int(st["inner_h"])}


def _tol_case():
    """A tol that bpp on problem 2 reaches at iteration 5 (as
    tests/test_torch_engine.py's tolerance case)."""
    rels = _jax_serial("bpp", 2, max_iters=8)["rels"]
    tol = float(rels[4]) * (1 + 1e-3)
    assert rels[3] > tol * (1 + 1e-3)
    return tol


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("faun"))
    tol = _tol_case()
    for pr, pc in GRIDS:
        rdist.spawn(_grid_rank, pr * pc, out, pr, pc, tol,
                    backend="gloo", device="cpu")
    return out, tol


def _load(out, tag, rank=0):
    with np.load(os.path.join(out, f"{tag}_r{rank}.npz")) as z:
        return {key: z[key] for key in z.files}


def _assert_like_jax(got, want):
    np.testing.assert_allclose(got["rels"], want["rels"], rtol=1e-4)
    _assert_scaled(got["W"], want["W"])
    _assert_scaled(got["H"], want["H"])
    assert int(got["iters"]) == want["iters"]
    assert int(got["inner_w"]) == want["inner_w"]
    assert int(got["inner_h"]) == want["inner_h"]


# ---------------------------------------------------------------------------
# faun and naive against the JAX serial oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_faun_matches_jax_serial(runs, grid, algo, backend):
    got = _load(runs[0], f"faun_{grid[0]}x{grid[1]}_{algo}_{backend}")
    assert got["W"].shape == (M, K) and got["H"].shape == (K, N)
    _assert_like_jax(got, _jax_serial(algo))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("p", sorted(NAIVE_GRIDS.values()))
def test_naive_matches_jax_serial(runs, p, algo, backend):
    got = _load(runs[0], f"naive_{p}_{algo}_{backend}")
    _assert_like_jax(got, _jax_serial(algo))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("schedule", ["faun", "naive"])
def test_one_rank_is_the_serial_schedule_bit_for_bit(runs, schedule, algo,
                                                     backend):
    """At 1×1 (p = 1) the collectives copy and the step runs the serial
    step's operations in its order: the same bits."""
    tag = "faun_1x1" if schedule == "faun" else "naive_1"
    got = _load(runs[0], f"{tag}_{algo}_{backend}")
    want = _load(runs[0], f"serial_{algo}_{backend}")
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_every_rank_holds_the_same_result_and_its_cell(runs, grid):
    out, (pr, pc) = runs[0], grid
    for r in range(pr * pc):
        cell = np.load(os.path.join(out, f"cell_{pr}x{pc}_r{r}.npy"))
        assert tuple(cell) == divmod(r, pc)
        for algo in ALGOS:
            for b in BACKENDS:
                tag = f"faun_{pr}x{pc}_{algo}_{b}"
                got, want = _load(out, tag, r), _load(out, tag, 0)
                for key in want:
                    np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("schedule", ["faun", "naive"])
@pytest.mark.parametrize("case", ["tol", "tol_ahals", "stall"])
def test_adaptive_stopping_holds_every_rank_in_lockstep(runs, case,
                                                        schedule):
    """tol= and stall_iters= on four ranks stop every rank at the JAX
    serial run's iteration, after the same inner sweeps."""
    out, tol = runs
    name, algo, seed, kw = next(c for c in _adaptive_cases(tol)
                                if c[0] == case)
    want = _jax_serial(algo, seed, **kw)
    assert want["iters"] < kw["max_iters"]
    tag = f"{schedule}_adaptive_{name}"
    for r in range(4):
        got = _load(out, tag, r)
        _assert_like_jax(got, want)
        assert got["rels"].shape == (want["iters"],)


@pytest.mark.parametrize("schedule", ["faun", "naive"])
def test_fit_wrappers_run_the_solver(runs, schedule):
    """``faun.fit`` / ``naive.fit`` (backend "cuda" for dense A) give the
    bits of ``NMFSolver`` on the same grid."""
    tag = "faun_2x2" if schedule == "faun" else "naive_4"
    want = _load(runs[0], f"{tag}_hals_cuda")
    for r in range(4):
        got = _load(runs[0], f"{schedule}_fit", r)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_faun_artifact_loads_in_the_jax_package(runs):
    from repro.serve.artifact import FactorArtifact as JaxArtifact
    got = JaxArtifact.load(os.path.join(runs[0], "artifact"))
    res = _load(runs[0], "faun_artifact")
    np.testing.assert_array_equal(np.asarray(got.W), res["W"])
    np.testing.assert_array_equal(np.asarray(got.H), res["H"])
    _assert_like_jax(res, _jax_serial("bpp"))


# ---------------------------------------------------------------------------
# Without ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["faun", "naive"])
def test_distributed_schedules_refuse_to_run_without_a_process_group(
        schedule):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        NMFSolver(K, schedule=schedule, device="cpu")


def test_unported_wire_options_are_refused():
    """Compression, gspmd and the profiler are ported; what is still
    refused names the item that ports it, and the wire options that do
    not apply are refused as in the reference.  lower_step is ported
    (item 12c): it counts one step."""
    assert "aten::mm" in NMFSolver(K, device="cpu").lower_step(
        M, N).as_text()
    assert "phase_times" in NMFSolver(K, device="cpu", max_iters=1).fit(
        _problem()[0], profile=True).extras
    with pytest.raises(RuntimeError, match="no process group"):
        NMFSolver(K, schedule="gspmd", device="cpu")
    with pytest.raises(ValueError, match="faun schedule only"):
        NMFSolver(K, panel_dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="sparse"):
        NMFSolver(K, schedule="faun", backend="sparse",
                  panel_dtype=torch.bfloat16, device="cpu")


def test_init_from_env_joins_the_torchrun_group(monkeypatch):
    """The environment torchrun sets, for one rank on this host (gloo on
    the CPU where there is no card)."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    for key, val in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                         MASTER_ADDR="127.0.0.1",
                         MASTER_PORT=str(port)).items():
        monkeypatch.setenv(key, val)
    dev = rdist.init_from_env()
    try:
        assert dev.type == ("cuda" if torch.cuda.is_available() else "cpu")
        assert dist.get_world_size() == 1
        grid = make_faun_grid(1, 1)
        assert (grid.pr, grid.pc, grid.i, grid.j) == (1, 1, 0, 0)
    finally:
        dist.destroy_process_group()


def test_a_failing_rank_fails_spawn():
    with pytest.raises(Exception, match="rank failed on purpose"):
        rdist.spawn(_raising_rank, 1, backend="gloo", device="cpu")


def test_spawn_defaults_to_cuda_ranks_and_refuses_without_a_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rdist.spawn(_raising_rank, 1)


@pytest.mark.parametrize("ops", [CudaOps(), DenseOps()],
                         ids=["cuda", "dense"])
def test_dense_blocks_are_views_where_they_can_be(ops):
    A = torch.from_numpy(_problem()[0])
    cpu = torch.device("cpu")
    assert ops.blockify(A, 1, 1, (0, 0), cpu).data_ptr() == A.data_ptr()
    row = ops.blockify(A, 4, 1, (2, 0), cpu)
    assert row.data_ptr() == A[48:72].data_ptr()          # a view
    col = ops.blockify(A, 2, 2, (1, 1), cpu)
    assert col.is_contiguous()
    assert torch.equal(col, A[48:, 32:])
    assert col.data_ptr() != A[48:, 32:].data_ptr()      # copied once
    a = _problem()[0]                                     # numpy: host slice
    assert torch.equal(ops.blockify(a, 2, 2, (0, 1), cpu),
                       torch.from_numpy(a[:48, 32:]))
    with pytest.raises(ValueError, match="does not tile"):
        ops.blockify(A, 5, 1, (0, 0), cpu)


# ---------------------------------------------------------------------------
# Sparse re-blocking against the reference's layout
# ---------------------------------------------------------------------------

def _sparse_A(seed=7):
    A = _problem(seed)[0]
    rng = np.random.default_rng(seed)
    A[rng.uniform(size=A.shape) > 0.25] = 0.0
    A[5:9] = 0.0                                   # empty rows and a block
    return A


@functools.cache
def _jax_blocks(src, dst):
    """The reference's layout of ``_sparse_A`` blocked on ``src`` and then
    re-blocked onto ``dst``."""
    import jax.numpy as jnp
    from repro.core import blocksparse as jblocksparse
    blk = jblocksparse.blockify(jnp.asarray(_sparse_A()), *src)
    out = jblocksparse.blockify(blk, *dst)
    back = jblocksparse.blockify(out, *src)
    return [{f: np.asarray(getattr(b, f)) for f in ("vals", "rows", "cols")}
            for b in (out, back)]


@pytest.mark.parametrize("src,dst", [((1, 1), (2, 2)), ((2, 2), (1, 1)),
                                     ((1, 1), (4, 1)), ((4, 1), (1, 1)),
                                     ((2, 2), (1, 4)), ((1, 2), (2, 1))],
                         ids=str)
def test_reblocking_equals_the_reference_layout(src, dst):
    """There and back again, array for array the reference's layouts; the
    way back keeps the first blocking's nnz_max (padding is stripped)."""
    blk = blocksparse.blockify(_sparse_A(), *src)
    out = blocksparse.blockify(blk, *dst)
    back = blocksparse.blockify(out, *src)
    for got, want in zip((out, back), _jax_blocks(src, dst)):
        for f in ("vals", "rows", "cols"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                          err_msg=f)
    assert out.grid == dst and out.nnz == back.nnz == blk.nnz
    assert back.vals.shape == blk.vals.shape
    A = torch.from_numpy(_sparse_A())
    assert torch.equal(out.todense(), A) and torch.equal(back.todense(), A)


def test_reblocking_a_sorted_layout_strips_its_padding():
    blk = blocksparse.blockify(_sparse_A(), 1, 1)
    srt = blk.sort_rows(align=16)
    assert srt.vals.shape[-1] > blk.vals.shape[-1]
    out = blocksparse.blockify(srt, 2, 2)
    want = blocksparse.blockify(blk, 2, 2)
    for f in ("vals", "rows", "cols"):
        assert torch.equal(getattr(out, f), getattr(want, f)), f
    assert out.row_major and not out.has_sorted_rows


@pytest.mark.parametrize("src", ["dense", "coo", "1x1", "2x1", "1x2",
                                 "sorted"])
def test_a_local_block_lays_out_only_its_own_triplets(src):
    A = _sparse_A()
    At = torch.from_numpy(A)
    form = {"dense": A, "coo": At.to_sparse_coo(),
            "1x1": blocksparse.blockify(A, 1, 1),
            "2x1": blocksparse.blockify(A, 2, 1),
            "1x2": blocksparse.blockify(A, 1, 2),
            "sorted": blocksparse.blockify(A, 1, 1).sort_rows(align=16)}[src]
    for (i, j) in [(0, 0), (0, 1), (1, 0), (1, 1)]:
        blk = blocksparse.local_block(form, 2, 2, i, j)
        part = At[48 * i:48 * (i + 1), 32 * j:32 * (j + 1)]
        count = int(torch.count_nonzero(part))
        assert blk.grid == (1, 1) and blk.shape == (48, 32)
        assert blk.vals.shape[-1] == max(count, 1) and blk.nnz == count
        assert torch.equal(blk.todense(), part)
        assert blk.row_major == (src != "1x2")
    one = blocksparse.blockify(A, 1, 1)
    assert blocksparse.local_block(one, 1, 1, 0, 0) is one
    with pytest.raises(ValueError, match="outside"):
        blocksparse.local_block(form, 2, 2, 2, 0)


@pytest.mark.parametrize("impl", ["scatter", "sorted"])
def test_a_ranks_sparse_block_is_its_part_of_A(impl):
    A = _sparse_A()
    ops = SparseOps(spmm_impl=impl)
    for (i, j) in [(0, 0), (0, 1), (1, 0), (1, 1)]:
        blk = ops.blockify(A, 2, 2, (i, j), torch.device("cpu"))
        assert blk.grid == (1, 1) and blk.shape == (48, 32)
        assert blk.is_sorted == (impl == "sorted")
        assert torch.equal(blk.todense(), torch.from_numpy(
            A[48 * i:48 * (i + 1), 32 * j:32 * (j + 1)]))
        assert blk.nnz == int(np.count_nonzero(
            A[48 * i:48 * (i + 1), 32 * j:32 * (j + 1)]))
    rows = ops.blockify(A, 2, 1, (1, 0), torch.device("cpu"),
                        products=("mm",))
    cols = ops.blockify(A, 1, 2, (0, 1), torch.device("cpu"),
                        products=("mm_t",))
    if impl == "sorted":
        assert rows.has_sorted_rows and not rows.has_sorted_cols
        assert cols.has_sorted_cols and not cols.has_sorted_rows
