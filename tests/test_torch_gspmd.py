"""The port's ``gspmd`` schedule (``core/gspmd.py``): the global-view
iteration over DTensor on gloo ranks, against the serial schedule (one
rank, bit for bit) and the JAX package's serial engine (2×2 and 4×1
meshes, within the faun tests' scaled 1e-4), compressed, refused where
the backend cannot be partitioned, and with the sparse triplets kept off
the wire.

Each mesh is spawned once per module; the rank bodies are top-level
functions of this module, which imports no JAX at its top.
"""

import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.backends import SparseOps
from repro_torch.core import blocksparse, gspmd
from repro_torch.core.engine import NMFSolver
from repro_torch.core.faun import make_faun_grid
from repro_torch.util import dist as rdist

M, N, K = 96, 64, 6
ITERS = 3
ALGOS = ["mu", "hals", "bpp", "amu", "ahals"]
BACKENDS = ["dense", "scatter", "cuda"]      # "scatter": sparse, on the CPU
MESHES = [(1, 1), (2, 2), (4, 1)]


def _problem(seed=0, noise=0.5):
    """Low rank plus noise (tests/test_torch_engine.py's problem)."""
    rng = np.random.default_rng(seed)
    A = (rng.uniform(size=(M, K)) @ rng.uniform(size=(K, N))
         + noise * rng.uniform(size=(M, N))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(M, K)).astype(np.float32)
    H0 = rng.uniform(size=(K, N)).astype(np.float32)
    return A, W0, H0


def _sparse_A():
    A = _problem()[0]
    A[np.random.default_rng(7).uniform(size=A.shape) > 0.25] = 0.0
    return A


def _backend(name):
    return SparseOps(spmm_impl=name) if name == "scatter" else name


def _save(out, tag, res):
    st = res.extras["rule_state"] or {}
    rows = dict(W=res.W.numpy(), H=res.H.numpy(),
                rels=res.rel_errors.numpy(), iters=res.iters,
                inner_w=st.get("inner_w", -1), inner_h=st.get("inner_h", -1))
    for key, v in (res.extras.get("panel_residuals") or {}).items():
        rows[f"res_{key}"] = v.numpy()
    np.savez(os.path.join(out, f"{tag}_r{dist.get_rank()}.npz"), **rows)


def _mesh_rank(out, pr, pc):
    A, W0, H0 = _problem()
    grid = make_faun_grid(pr, pc)
    for algo in ALGOS:
        for b in BACKENDS:
            if b == "cuda" and pr * pc > 1:
                continue
            kw = dict(algo=algo, backend=_backend(b), device="cpu",
                      max_iters=ITERS)
            _save(out, f"gspmd_{pr}x{pc}_{algo}_{b}", NMFSolver(
                K, schedule="gspmd", grid=grid, **kw).fit(A, W0=W0, H0=H0))
            if (pr, pc) == (1, 1):
                _save(out, f"serial_{algo}_{b}",
                      NMFSolver(K, **kw).fit(A, W0=W0, H0=H0))
    for c in (None, "int8"):
        _save(out, f"comp_{pr}x{pc}_{c}", NMFSolver(
            K, algo="mu", schedule="gspmd", grid=grid, backend="dense",
            panel_compression=c, max_iters=20, device="cpu").fit(
                A, W0=W0, H0=H0))
    if (pr, pc) != (2, 2):
        return
    # a backend DTensor cannot partition is refused on more than one rank
    try:
        NMFSolver(K, schedule="gspmd", grid=grid, backend="cuda",
                  device="cpu")
        refused = ""
    except ValueError as e:
        refused = str(e)
    np.save(os.path.join(out, "refused.npy"), np.array(refused))
    # adaptive stopping in lockstep, and the legacy fit wrapper
    _save(out, "gspmd_adaptive", NMFSolver(
        K, algo="mu", schedule="gspmd", grid=grid, backend="dense",
        max_iters=40, stall_iters=2, stall_tol=2e-3, device="cpu").fit(
            A, W0=W0, H0=H0))
    _save(out, "gspmd_fit", gspmd.fit(A, K, grid=grid, algo="hals",
                                      iters=ITERS, W0=W0, H0=H0,
                                      device="cpu"))
    # the LUC kernels' wrappers take this rank's rows as plain tensors
    from repro_torch.kernels import ops as kops
    calls, real = [], {n: getattr(kops, n) for n in ("mu_update",
                                                     "hals_sweep")}

    def spy(name):
        def wrapper(X, G, R, **kw):
            calls.append((name, b, type(X).__name__, type(G).__name__,
                          type(R).__name__, X.shape[0], R.shape[0]))
            return real[name](X, G, R, **kw)
        return wrapper

    try:
        for name in real:
            setattr(kops, name, spy(name))
        for algo in ("mu", "hals"):
            for b in ("dense", "sparse"):
                NMFSolver(K, algo=algo, schedule="gspmd", grid=grid,
                          backend=b, max_iters=1, device="cpu").fit(
                    _sparse_A() if b == "sparse" else A, W0=W0, H0=H0)
    finally:
        for name, fn in real.items():
            setattr(kops, name, fn)
    np.save(os.path.join(out, f"luc_calls_r{dist.get_rank()}.npy"),
            np.array(calls, dtype=object), allow_pickle=True)
    # the sparse wire: one iteration's collectives
    from repro_torch.util.wire import record_wire
    As = _sparse_A()
    for comp in (None, "int8"):
        solver = NMFSolver(K, algo="mu", schedule="gspmd", grid=grid,
                           backend="sparse", panel_compression=comp,
                           device="cpu")
        rs = solver.prepare_state(As, W0=W0, H0=H0)
        solver.run_segment(rs, 1)
        with record_wire() as log:
            solver.run_segment(rs, 1)
        np.save(os.path.join(out, f"wire_{comp}_r{dist.get_rank()}.npy"),
                np.array([(c.op, str(c.dtype), list(c.shape)) for c in log],
                         dtype=object), allow_pickle=True)
        np.save(os.path.join(out, f"share_{comp}_r{dist.get_rank()}.npy"),
                np.array([rs.A.vals.numel(), rs.A.nnz]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("gspmd"))
    for pr, pc in MESHES:
        rdist.spawn(_mesh_rank, pr * pc, out, pr, pc, backend="gloo",
                    device="cpu")
    return out


def _load(out, tag, rank=0):
    with np.load(os.path.join(out, f"{tag}_r{rank}.npz")) as z:
        return {key: z[key] for key in z.files}


@functools.cache
def _jax_serial(algo, **kw):
    import jax.numpy as jnp
    from repro.core.engine import NMFSolver as JaxSolver
    A, W0, H0 = _problem()
    kw.setdefault("max_iters", ITERS)
    res = JaxSolver(K, algo=algo, backend="dense", **kw).fit(
        jnp.asarray(A), W0=jnp.asarray(W0), H0=jnp.asarray(H0))
    st = res.extras["rule_state"]
    return {"W": np.asarray(res.W), "H": np.asarray(res.H),
            "rels": np.asarray(res.rel_errors), "iters": int(res.iters),
            "inner_w": -1 if st is None else int(st["inner_w"]),
            "inner_h": -1 if st is None else int(st["inner_h"])}


def _assert_scaled(got, want, atol=1e-4):
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _assert_like_jax(got, want):
    np.testing.assert_allclose(got["rels"], want["rels"], rtol=1e-4)
    _assert_scaled(got["W"], want["W"])
    _assert_scaled(got["H"], want["H"])
    assert int(got["iters"]) == want["iters"]
    assert int(got["inner_w"]) == want["inner_w"]
    assert int(got["inner_h"]) == want["inner_h"]


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("algo", ALGOS)
def test_one_rank_gspmd_is_the_serial_schedule_bit_for_bit(runs, algo,
                                                          backend):
    got = _load(runs, f"gspmd_1x1_{algo}_{backend}")
    want = _load(runs, f"serial_{algo}_{backend}")
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("backend", ["dense", "scatter"])
@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_gspmd_matches_jax_serial(runs, mesh, algo, backend):
    pr, pc = mesh
    for r in range(pr * pc):
        got = _load(runs, f"gspmd_{pr}x{pc}_{algo}_{backend}", r)
        assert got["W"].shape == (M, K) and got["H"].shape == (K, N)
        _assert_like_jax(got, _jax_serial(algo))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda g: f"{g[0]}x{g[1]}")
def test_compressed_gspmd_stays_near_exact(runs, mesh):
    pr, pc = mesh
    ex = _load(runs, f"comp_{pr}x{pc}_None")
    co = _load(runs, f"comp_{pr}x{pc}_int8")
    assert abs(float(co["rels"][-1]) - float(ex["rels"][-1])) < 5e-3
    res = {key[4:]: v for key, v in co.items() if key.startswith("res_")}
    assert sorted(res) == ["gram_h", "gram_w", "rs_h", "rs_w"]
    assert res["rs_w"].shape == (M, K) and res["rs_h"].shape == (N, K)
    assert any(np.abs(v).max() > 0 for v in res.values())
    assert not any(k.startswith("res_") for k in ex)


def test_gspmd_runs_the_luc_kernels_on_each_ranks_rows(runs):
    """The LUC kernels are opaque to DTensor: on the 2×2 mesh each rank's
    rule gets its own rows as plain tensors (so the kernels launch on the
    card), mu twice an iteration and hals's H-step sweep once, for the
    dense and the sparse backend."""
    for r in range(4):
        calls = np.load(os.path.join(runs, f"luc_calls_r{r}.npy"),
                        allow_pickle=True).tolist()
        want = [("mu_update", "dense", M // 4), ("mu_update", "dense", N // 4),
                ("mu_update", "sparse", M // 4),
                ("mu_update", "sparse", N // 4),
                ("hals_sweep", "dense", N // 4),
                ("hals_sweep", "sparse", N // 4)]
        assert [(c[0], c[1], c[5]) for c in calls] == want, calls
        for c in calls:
            assert tuple(c[2:5]) == ("Tensor",) * 3 and c[5] == c[6], c


def test_cuda_gspmd_is_refused_on_more_than_one_rank(runs):
    msg = str(np.load(os.path.join(runs, "refused.npy")))
    assert "single-device only" in msg and "'cuda'" in msg


def test_gspmd_stops_every_rank_in_lockstep(runs):
    want = _jax_serial("mu", max_iters=40, stall_iters=2, stall_tol=2e-3)
    assert want["iters"] < 40
    for r in range(4):
        _assert_like_jax(_load(runs, "gspmd_adaptive", r), want)


def test_gspmd_fit_wrapper(runs):
    _assert_like_jax(_load(runs, "gspmd_fit"), _jax_serial("hals"))


@pytest.mark.parametrize("comp", [None, "int8"])
def test_sparse_gspmd_never_moves_a_triplet(runs, comp):
    """The counterpart of ``gspmd_sparse_auto_partitioner_keeps_A_local``:
    each rank holds a quarter of the padded triplets, and every collective
    of an iteration is k-width or smaller."""
    nnz = int(np.count_nonzero(_sparse_A()))
    for r in range(4):
        held, total = np.load(os.path.join(runs, f"share_{comp}_r{r}.npy"))
        assert total == nnz and held == -(-nnz // 4)
        wire = np.load(os.path.join(runs, f"wire_{comp}_r{r}.npy"),
                       allow_pickle=True)
        assert len(wire)
        for op, dt, shape in wire:
            assert len(shape) <= 2, (op, shape)
            assert len(shape) < 2 or shape[1] <= K, (op, dt, shape)
            assert int(np.prod(shape)) <= max(M, N) * K, (op, dt, shape)


def test_pad_nnz_matches_the_reference():
    import jax.numpy as jnp
    from repro.core import blocksparse as jblocksparse
    A = _sparse_A()
    for multiple in (1, 3, 4, 7):
        got = blocksparse.pad_nnz(blocksparse.blockify(A, 1, 1), multiple)
        want = jblocksparse.pad_nnz(
            jblocksparse.blockify(jnp.asarray(A), 1, 1), multiple)
        for f in ("vals", "rows", "cols"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
        assert got.vals.shape[-1] % multiple == 0
        assert torch.equal(got.todense(), torch.from_numpy(A))
    srt = blocksparse.blockify(A, 1, 1).sort_rows(align=16)
    padded = blocksparse.pad_nnz(srt, 4)
    assert not padded.has_sorted_rows and padded.align == 0
    assert torch.equal(padded.todense(), torch.from_numpy(A))


def test_sorted_sparse_takes_the_unsorted_products_in_gspmd():
    assert SparseOps(spmm_impl="sorted").global_view_ops().spmm_impl \
        == "auto"
    ops = SparseOps(spmm_impl="scatter")
    assert ops.global_view_ops() is ops


def test_gspmd_refuses_to_run_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        NMFSolver(K, schedule="gspmd", device="cpu")
