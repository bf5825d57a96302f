"""The port's sparse path against the JAX package's: the sorted layout
array for array, the local SpMMs of every port impl against every
reference impl (its Pallas kernels in interpret mode), the kernel wrappers,
the BlockCOO round trips, ||A||², and NMFSolver(backend="sparse") as a
whole, on inputs made with numpy from a seed.

On the CPU the port's kernel wrappers run their plain versions; the CUDA
kernels themselves are held against those on the card by
test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import SparseOps as JaxSparseOps
from repro.core import blocksparse as jbs
from repro.core.engine import NMFSolver as JaxSolver
from repro.kernels import ops as jops
from repro_torch.backends import SparseOps, infer_backend
from repro_torch.core import blocksparse as tbs
from repro_torch.core.engine import NMFSolver
from repro_torch.data.pipeline import erdos_renyi_bcoo
from repro_torch.kernels import ops
from repro_torch.util.convert import blockcoo_from_numpy, blockcoo_to_numpy

torch.set_num_threads(1)

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
TOL = {"f32": 1e-5, "bf16": 2e-2}   # scaled atol, as in test_spmm.py
SORT_ALIGN = 16                     # small align keeps interpret mode cheap
JAX_IMPLS = ("scatter", "pallas", "sorted")
PORT_IMPLS = ("scatter", "cuda", "sorted")


def _er(seed, m, n, density):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(m, n))
            * (rng.uniform(size=(m, n)) < density)).astype(np.float32)


def _hot_row():
    """test_sorted_ragged_nnz_rows's matrix: one hot row, many empty rows
    and tiles."""
    Ad = np.zeros((40, 24), np.float32)
    Ad[3] = np.random.default_rng(7).uniform(size=24)
    Ad[17, 5] = 1.25
    return Ad


# name -> (dense A or raw triplets, grid, k, align)
CASES = {
    "er_1x1": (lambda: _er(1, 64, 48, 0.25), (1, 1), 8, SORT_ALIGN),
    "er_2x3": (lambda: _er(2, 32, 36, 0.25), (2, 3), 5, SORT_ALIGN),
    "ragged": (lambda: _er(3, 37, 29, 0.2), (1, 1), 7, SORT_ALIGN),
    "empty": (lambda: np.zeros((32, 24), np.float32), (2, 2), 5, SORT_ALIGN),
    "hot_row": (_hot_row, (1, 1), 5, 8),
    "duplicates": (lambda: (np.array([1.0, 2.0, 4.0, 8.0, 16.0], np.float32),
                            np.array([5, 5, 5, 2, 5], np.int32),
                            np.array([1, 1, 3, 0, 1], np.int32), (16, 8)),
                   (1, 1), 3, 8),
}


def _blocks(name, dt):
    """The case's matrix as the same BlockCOO in both packages (the port's
    made from the reference's leaves) with A in ``dt``, its k and align."""
    make, (gr, gc), k, align = CASES[name]
    data = make()
    if isinstance(data, tuple):
        vals, rows, cols, (m, n) = data
        jblk = jbs._pack_triplets(vals, rows, cols, m, n, gr, gc,
                                  nnz=vals.size)
    else:
        jblk = jbs.blockify(jnp.asarray(data), gr, gc)
    jblk = dataclasses.replace(jblk, vals=jblk.vals.astype(DTYPES[dt][1]))
    return jblk, blockcoo_from_numpy(jblk), k, align


def _sub(blk, i, j, cls):
    """The (i, j) grid block as its own 1×1 BlockCOO, sort leaves too."""
    leaves = {f.name: getattr(blk, f.name)[i:i + 1, j:j + 1]
              for f in dataclasses.fields(blk)
              if f.name not in ("shape", "block_shape", "nnz", "align",
                                "row_major")
              and getattr(blk, f.name) is not None}
    return cls(shape=blk.block_shape, block_shape=blk.block_shape,
               nnz=blk.nnz, align=blk.align, **leaves)


def _grid_products(blk, B, C, local, local_t, cls, to_np):
    """Σ_j A_ij B_j per block row and Σ_i A_ijᵀ C_i per block column."""
    (gr, gc), (mb, nb) = blk.grid, blk.block_shape
    out = np.zeros((blk.shape[0], B.shape[1]), np.float32)
    out_t = np.zeros((blk.shape[1], C.shape[1]), np.float32)
    for i in range(gr):
        for j in range(gc):
            b = _sub(blk, i, j, cls)
            out[i * mb:(i + 1) * mb] += to_np(local(b, B[j * nb:(j + 1) * nb]))
            out_t[j * nb:(j + 1) * nb] += to_np(
                local_t(b, C[i * mb:(i + 1) * mb]))
    return out, out_t


def _assert_scaled(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=tol)


@functools.cache
def _jax_products(name, dt):
    """The reference's A·B and Aᵀ·C for each of its impls."""
    jblk, _, k, align = _blocks(name, dt)
    rng = np.random.default_rng(11)
    b = rng.uniform(size=(jblk.shape[1], k)).astype(np.float32)
    c = rng.uniform(size=(jblk.shape[0], k)).astype(np.float32)
    jdt = DTYPES[dt][1]
    out = {}
    for impl in JAX_IMPLS:
        rep = jblk.sort_rows(align=align) if impl == "sorted" else jblk
        out[impl] = _grid_products(
            rep, jnp.asarray(b).astype(jdt), jnp.asarray(c).astype(jdt),
            functools.partial(jbs.local_spmm, impl=impl),
            functools.partial(jbs.local_spmm_t, impl=impl), jbs.BlockCOO,
            lambda x: np.asarray(x, np.float32))
    return b, c, out


# ---------------------------------------------------------------------------
# Storage and the sorted layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (3, 2)])
@pytest.mark.parametrize("dt", DTYPES)
def test_blockify_packs_like_jax(grid, dt):
    """The same dense A gives the same padded triplets, array for array."""
    Ad = _er(4, 48, 36, 0.2)
    jblk = jbs.blockify(jnp.asarray(Ad).astype(DTYPES[dt][1]), *grid)
    blk = tbs.blockify(torch.from_numpy(Ad).to(DTYPES[dt][0]), *grid)
    want = blockcoo_to_numpy(blockcoo_from_numpy(jblk))
    got = blockcoo_to_numpy(blk)
    for f in ("vals", "rows", "cols"):
        assert got[f].dtype == want[f].dtype
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert (blk.shape, blk.block_shape, blk.nnz, blk.grid) == (
        jblk.shape, jblk.block_shape, jblk.nnz, jblk.grid)
    np.testing.assert_array_equal(blk.todense().float().numpy(),
                                  np.asarray(jblk.todense(), np.float32))


@pytest.mark.parametrize("align", [8, 16])
@pytest.mark.parametrize("orient", ["both", "rows", "cols"])
@pytest.mark.parametrize("grid", [(1, 1), (2, 2), (3, 2)])
def test_sort_rows_layout_matches_jax(grid, orient, align):
    """The vectorised sort gives the reference's layout array for array:
    stable order, padding (tile's first row, 0, 0), valid counts, tail
    padding carrying the last tile id, offsets counting the pack padding."""
    Ad = _er(5, 16 * grid[0] * 2, 12 * grid[1] * 2, 0.2)
    Ad[3] = np.random.default_rng(6).uniform(size=Ad.shape[1])  # hot row
    jblk = jbs.blockify(jnp.asarray(Ad), *grid)
    want = jblk.sort_rows(align=align, orient=orient)
    got = blockcoo_from_numpy(jblk).sort_rows(align=align, orient=orient)
    want_np = blockcoo_to_numpy(blockcoo_from_numpy(want))
    got_np = blockcoo_to_numpy(got)
    assert got_np.keys() == want_np.keys()
    for f, w in want_np.items():
        g = got_np[f]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            assert g == w, f
    np.testing.assert_array_equal(got.todense().numpy(), Ad)


def test_blockify_takes_every_input_form():
    """Dense tensor, numpy (float64 → float32), sparse COO with duplicates,
    CSR, and a BlockCOO on its own grid; another grid is not ported."""
    Ad = _er(7, 24, 20, 0.3)
    want = torch.from_numpy(Ad)
    coo = want.to_sparse_coo()
    idx, vals = coo.indices(), coo.values()
    dup = torch.sparse_coo_tensor(torch.cat([idx, idx[:, :3]], 1),
                                  torch.cat([vals / 2, vals[:3] / 2]),
                                  want.shape)
    dup_dense = want.clone()
    dup_dense[idx[0], idx[1]] /= 2
    dup_dense[idx[0, :3], idx[1, :3]] += vals[:3] / 2
    for A, dense in ((want, want), (Ad.astype(np.float64), want),
                     (coo, want), (want.to_sparse_csr(), want),
                     (dup, dup_dense)):
        blk = tbs.blockify(A, 2, 2)
        assert blk.dtype == torch.float32 and blk.grid == (2, 2)
        torch.testing.assert_close(blk.todense(), dense)
    blk = tbs.blockify(want, 2, 2)
    assert tbs.blockify(blk, 2, 2) is blk
    with pytest.raises(NotImplementedError, match="faun"):
        tbs.blockify(blk, 1, 1)
    with pytest.raises(NotImplementedError, match="gspmd"):
        tbs.pad_nnz(blk, 4)


@pytest.mark.parametrize("sort", [False, True])
def test_blockcoo_round_trips(sort):
    """JAX → port → JAX keeps every leaf; a layout sorted by the port runs
    in the reference's sorted kernel, and the reverse."""
    Ad = _er(8, 32, 24, 0.25)
    jblk = jbs.blockify(jnp.asarray(Ad), 1, 1)
    if sort:
        jblk = jblk.sort_rows(align=SORT_ALIGN)
    back = blockcoo_to_numpy(blockcoo_from_numpy(jblk))
    again = jbs.BlockCOO(**{f: jnp.asarray(v) if isinstance(v, np.ndarray)
                            else v for f, v in back.items()})
    for f in tbs.LEAVES:
        a, b = getattr(jblk, f), getattr(again, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert (again.shape, again.block_shape, again.nnz, again.align) == (
        jblk.shape, jblk.block_shape, jblk.nnz, jblk.align)
    B = np.random.default_rng(9).uniform(size=(24, 4)).astype(np.float32)
    port_sorted = tbs.blockify(Ad, 1, 1).sort_rows(align=SORT_ALIGN)
    in_jax = jbs.BlockCOO(**{f: jnp.asarray(v) if isinstance(v, np.ndarray)
                             else v for f, v in
                             blockcoo_to_numpy(port_sorted).items()})
    np.testing.assert_allclose(
        np.asarray(jbs.local_spmm(in_jax, jnp.asarray(B), impl="sorted")),
        Ad @ B, atol=1e-5)
    in_port = blockcoo_from_numpy(jblk.sort_rows(align=SORT_ALIGN))
    np.testing.assert_allclose(
        tbs.local_spmm(in_port, torch.from_numpy(B), impl="sorted").numpy(),
        Ad @ B, atol=1e-5)


@pytest.mark.parametrize("grid", [(1, 1), (3, 2)])
@pytest.mark.parametrize("sort", [False, True])
def test_sq_norm_matches_jax(grid, sort):
    jblk = jbs.blockify(jnp.asarray(_er(10, 48, 36, 0.3)), *grid)
    if sort:
        jblk = jblk.sort_rows(align=SORT_ALIGN)
    got = tbs.sq_norm(blockcoo_from_numpy(jblk))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(jbs.sq_norm(jblk)),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# The products
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dt", DTYPES)
def test_local_spmm_matches_jax(name, dt):
    """Every port impl against every reference impl, both products: fp32
    and bf16, duplicate indices, all-empty blocks, a hot row, ragged
    shapes, a 2×3 grid of local blocks."""
    b, c, want = _jax_products(name, dt)
    _, blk, _, align = _blocks(name, dt)
    tdt = DTYPES[dt][0]
    B, C = torch.from_numpy(b).to(tdt), torch.from_numpy(c).to(tdt)
    for impl in PORT_IMPLS:
        rep = blk.sort_rows(align=align) if impl == "sorted" else blk
        got = _grid_products(
            rep, B, C, functools.partial(tbs.local_spmm, impl=impl),
            functools.partial(tbs.local_spmm_t, impl=impl), tbs.BlockCOO,
            lambda x: x.numpy())
        for out, out_t in want.values():
            _assert_scaled(got[0], out, TOL[dt])
            _assert_scaled(got[1], out_t, TOL[dt])
        if name == "empty":
            assert not got[0].any() and not got[1].any()
    if name == "hot_row":      # rows without nonzeros are exactly 0
        out = tbs.local_spmm(blk.sort_rows(align=align), B, impl="sorted")
        assert not out[[r for r in range(40) if r not in (3, 17)]].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dt", DTYPES)
def test_kernel_wrappers_match_jax_ops(seed, dt):
    """ops.spmm / spmm_t on raw triplets with duplicates, and spmm_sorted
    on a packed layout, against the reference's wrappers."""
    rng = np.random.default_rng(seed)
    m, n, k, nnz = (int(x) for x in rng.integers((1, 1, 1, 0),
                                                  (64, 48, 16, 300)))
    rows = rng.integers(0, m, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.uniform(size=nnz).astype(np.float32)
    b = rng.uniform(size=(n, k)).astype(np.float32)
    c = rng.uniform(size=(m, k)).astype(np.float32)
    tdt, jdt = DTYPES[dt]
    tv, jv = torch.from_numpy(vals).to(tdt), jnp.asarray(vals).astype(jdt)
    tr, tc = torch.from_numpy(rows), torch.from_numpy(cols)
    jr, jc = jnp.asarray(rows), jnp.asarray(cols)
    tb, jb = torch.from_numpy(b).to(tdt), jnp.asarray(b).astype(jdt)
    tcc, jcc = torch.from_numpy(c).to(tdt), jnp.asarray(c).astype(jdt)
    _assert_scaled(ops.spmm(tv, tr, tc, tb, m).numpy(),
                   jops.spmm(jv, jr, jc, jb, m), TOL[dt])
    _assert_scaled(ops.spmm_t(tv, tr, tc, tcc, n).numpy(),
                   jops.spmm_t(jv, jr, jc, jcc, n), TOL[dt])
    jblk = jbs._pack_triplets(vals, rows, cols, m, n, 1, 1, nnz=nnz)
    srt = dataclasses.replace(jblk, vals=jblk.vals.astype(jdt)).sort_rows(
        align=8)
    port = blockcoo_from_numpy(srt)
    args = [getattr(port, f).reshape(-1) for f in
            ("vals", "rows", "cols", "row_tiles", "row_valid")]
    want = jops.spmm_sorted(*(getattr(srt, f).reshape(-1) for f in (
        "vals", "rows", "cols", "row_offsets", "row_tiles", "row_valid")),
        jb, m, align=8)
    _assert_scaled(ops.spmm_sorted(*args, tb, m, align=8).numpy(), want,
                   TOL[dt])


def test_wrappers_refuse_what_the_kernels_do_not_take():
    blk = tbs.blockify(torch.eye(16), 1, 1).sort_rows(align=8)
    v, r, c = (t.reshape(-1) for t in (blk.vals, blk.rows, blk.cols))
    B = torch.rand(16, 4)
    with pytest.raises(ValueError, match="contiguous"):       # a Hᵀ view
        ops.spmm(v, r, c, torch.rand(4, 16).T, 16)
    with pytest.raises(ValueError, match="dtype"):
        ops.spmm(v.bfloat16(), r, c, B, 16)
    with pytest.raises(TypeError, match="int32"):
        ops.spmm(v, r.long(), c, B, 16)
    with pytest.raises(ValueError, match="lengths"):
        ops.spmm(v, r[:-1], c, B, 16)
    tiles, valid = blk.row_tiles.reshape(-1), blk.row_valid.reshape(-1)
    with pytest.raises(ValueError, match="align"):
        ops.spmm_sorted(v, r, c, tiles, valid, B, 16, align=16)
    with pytest.raises(ValueError, match="dtype"):
        ops.spmm_sorted(v, r, c, tiles, valid, B.bfloat16(), 16, align=8)


def test_sorted_needs_its_orientation():
    blk = tbs.blockify(torch.rand(32, 24) * (torch.rand(32, 24) < 0.2), 1, 1)
    B, C = torch.rand(24, 5), torch.rand(32, 5)
    with pytest.raises(ValueError, match="sort_rows"):
        tbs.local_spmm(blk, B, impl="sorted")
    rows_only = blk.sort_rows(align=SORT_ALIGN, orient="rows")
    assert rows_only.has_sorted_rows and not rows_only.has_sorted_cols
    torch.testing.assert_close(tbs.local_spmm(rows_only, B, impl="sorted"),
                               blk.todense() @ B)
    with pytest.raises(ValueError, match="orient"):
        tbs.local_spmm_t(rows_only, C, impl="sorted")
    cols_only = blk.sort_rows(align=SORT_ALIGN, orient="cols")
    torch.testing.assert_close(tbs.local_spmm_t(cols_only, C, impl="sorted"),
                               blk.todense().T @ C)
    with pytest.raises(ValueError, match="orient"):
        tbs.local_spmm(cols_only, B, impl="sorted")
    with pytest.raises(ValueError, match="ONE local block"):
        tbs.local_spmm(tbs.blockify(torch.eye(8), 2, 2).sort_rows(align=8),
                       torch.rand(4, 2), impl="sorted")
    with pytest.raises(ValueError, match="impl"):
        tbs.local_spmm(blk, B, impl="pallas")


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

M, N, K = 96, 64, 6


def _problem():
    """A sparse, noisy A (rel err ≈ 0.85, far above the trace trick's fp32
    cancellation) and explicit factors."""
    rng = np.random.default_rng(12)
    A = _er(12, M, N, 0.3)
    W0 = rng.uniform(0.1, 1.0, size=(M, K)).astype(np.float32)
    H0 = rng.uniform(size=(K, N)).astype(np.float32)
    return A, W0, H0


@functools.cache
def _jax_fit(algo, backend):
    A, W0, H0 = _problem()
    ops_ = ("sparse" if backend == "sparse"
            else JaxSparseOps(spmm_impl="sorted", align=SORT_ALIGN))
    res = JaxSolver(K, algo=algo, backend=ops_, max_iters=3).fit(
        jnp.asarray(A), W0=jnp.asarray(W0), H0=jnp.asarray(H0))
    return (np.asarray(res.rel_errors), np.asarray(res.W),
            np.asarray(res.H))


@pytest.mark.parametrize("impl", ["auto", "sorted", "cuda"])
@pytest.mark.parametrize("jax_backend", ["sparse", "sorted"])
@pytest.mark.parametrize("algo", ["mu", "hals", "bpp"])
def test_sparse_fit_matches_jax(algo, jax_backend, impl):
    A, W0, H0 = _problem()
    res = NMFSolver(K, algo=algo, device="cpu", max_iters=3,
                    backend=SparseOps(spmm_impl=impl, align=SORT_ALIGN)
                    ).fit(A, W0=W0, H0=H0)
    rels, W, H = _jax_fit(algo, jax_backend)
    np.testing.assert_allclose(res.rel_errors.numpy(), rels, rtol=1e-4)
    _assert_scaled(res.W.numpy(), W, 1e-4)
    _assert_scaled(res.H.numpy(), H, 1e-4)
    assert res.extras["backend"] == "sparse" and res.iters == 3
    assert res.W.shape == (M, K) and res.H.shape == (K, N)


def test_sparse_fit_takes_every_input_form():
    """A numpy array, a sparse COO tensor and a BlockCOO (sorted or not)
    give the same fit."""
    A, W0, H0 = _problem()
    want = NMFSolver(K, algo="mu", backend="sparse", device="cpu",
                     max_iters=2).fit(A, W0=W0, H0=H0)
    coo = torch.from_numpy(A).to_sparse_coo()
    for data in (coo, tbs.blockify(coo, 1, 1),
                 tbs.blockify(A, 1, 1).sort_rows()):
        got = NMFSolver(K, algo="mu", backend="sparse", device="cpu",
                        max_iters=2).fit(data, W0=W0, H0=H0)
        torch.testing.assert_close(got.W, want.W)
        torch.testing.assert_close(got.rel_errors, want.rel_errors)


def test_sparse_backend_resolution():
    """infer_backend names "sparse" for sparse storage; a dense backend
    points to it; the sparse solver runs on CUDA unless told otherwise."""
    A = torch.rand(8, 6) * (torch.rand(8, 6) < 0.5)
    assert infer_backend(A.to_sparse_coo()) == "sparse"
    assert infer_backend(tbs.blockify(A, 1, 1)) == "sparse"
    assert infer_backend(A) == infer_backend(A.numpy()) == "dense"
    with pytest.raises(ValueError, match="backend='sparse'"):
        NMFSolver(2, backend="dense", device="cpu").fit(A.to_sparse_coo())
    with pytest.raises(ValueError, match="backend='sparse'"):
        NMFSolver(2, device="cpu").fit(tbs.blockify(A, 1, 1))
    if torch.cuda.is_available():
        assert NMFSolver(50, backend="sparse").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            NMFSolver(50, backend="sparse")


def test_erdos_renyi_bcoo_draws():
    """No stored zero, no duplicate, row-major order, density·m·n draws
    less their expected duplicates (draws² / 2mn = 75 here), values on
    (0, 1]; the same seed gives the same matrix."""
    gen = torch.Generator().manual_seed(0)
    A = erdos_renyi_bcoo(gen, 300, 200, 0.05)
    assert A.is_coalesced() and A.shape == (300, 200)
    v, idx = A.values(), A.indices()
    assert (v > 0).all() and (v <= 1).all()
    lin = idx[0] * 200 + idx[1]
    assert (lin[1:] > lin[:-1]).all()
    assert abs(v.numel() - (3000 - 75)) < 40
    again = erdos_renyi_bcoo(torch.Generator().manual_seed(0), 300, 200, 0.05)
    assert torch.equal(again.indices(), idx) and torch.equal(again.values(), v)
    bf = erdos_renyi_bcoo(torch.Generator().manual_seed(1), 64, 64, 0.3,
                          dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and (bf.values() > 0).all()
