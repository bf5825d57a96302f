"""The port's CUDA kernels and its engine on the card, held against their
plain PyTorch versions (the CPU path, itself held against the JAX package
by the other test_torch_* files).

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither jax nor the JAX package, so it runs on a machine that has
only PyTorch; from the repo root (``--noconftest``: tests/conftest.py
imports jax):

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.backends import SparseOps
from repro_torch.core import blocksparse, rules
from repro_torch.core.engine import NMFSolver
from repro_torch.kernels import ops, ref
from repro_torch.serve.artifact import FactorArtifact
from repro_torch.serve.foldin import FoldInProjector
from repro_torch.serve.topk import TopK

# The shapes of tests/test_kernels.py, the main path's widths on a
# 65,536-row slice, and ragged edges on every axis (k > 64 takes a second
# k-tile; m = 1 a single row).
SHAPES = [(64, 48, 8), (96, 128, 16), (100, 70, 10), (128, 64, 50),
          (32, 256, 4), (65_536, 13_824, 50), (4_099, 1_001, 70),
          (1, 33, 1)]
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 1e-5, "bf16": 2e-2}   # scaled atol, as in test_kernels.py


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False     # exact fp32 references
    return torch.device("cuda")


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=s).astype(np.float32) for s in shapes]


def _launches(**counts):
    """ops.LAUNCHES as it should read: ``counts``, every other kernel 0."""
    return {name: counts.get(name, 0) for name in ops.LAUNCHES}


def _assert_scaled(got, want, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_kernels_match_plain_versions(cuda_device, m, n, k, dt):
    a, b, w = _inputs(6, (m, n), (n, k), (m, k))
    A, B, W = (torch.from_numpy(x).to(cuda_device, DTYPES[dt])
               for x in (a, b, w))
    ops.reset_launches()
    for got, want in ((ops.ts_matmul(A, B), ref.ts_matmul(A, B)),
                      (ops.ts_matmul_t(A, W), ref.ts_matmul_t(A, W)),
                      (ops.gram(W), ref.gram(W))):
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.is_cuda
        _assert_scaled(got.cpu(), want.cpu(), TOL[dt])
    assert ops.LAUNCHES == _launches(gram=1, ts_matmul=1, ts_matmul_t=1)


@pytest.mark.cuda
def test_kernels_are_reproducible_and_gram_symmetric(cuda_device):
    a, w = _inputs(7, (20_000, 300), (20_000, 50))
    A = torch.from_numpy(a).to(cuda_device)
    W = torch.from_numpy(w).to(cuda_device)
    assert torch.equal(ops.ts_matmul_t(A, W), ops.ts_matmul_t(A, W))
    G = ops.gram(W)
    assert torch.equal(G, ops.gram(W)) and torch.equal(G, G.T)


@pytest.mark.cuda
def test_wrappers_refuse_strided_cuda_operands(cuda_device):
    A = torch.rand(64, 32, device=cuda_device)
    with pytest.raises(ValueError):
        ops.ts_matmul(A.T, torch.rand(64, 4, device=cuda_device))


# The gram and ts_matmul designs: a served column batch (b rows of Video's
# 1,013,400-long contraction against W: ts_matmul splits the contraction),
# k from 1 to 128, and shapes whose rows are not 16-byte aligned (n not a
# multiple of 4, or a view one element off the grid: 4-byte copies).
SERVE_N = 1_013_400
REDESIGN_K = [1, 50, 56, 64, 70, 128]
REDESIGN_MN = [(300, 1_003), (129, 4_096), (5, 70_001)]


def _device_inputs(device, seed, *shapes):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.rand(s, generator=gen, device=device) for s in shapes]


def _off_grid(x):
    """x's values in a contiguous tensor that starts one element past a
    16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = flat[1:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 64, 256])
@pytest.mark.parametrize("dt", DTYPES)
def test_ts_matmul_at_the_served_column_shapes(cuda_device, b, dt):
    C, W = (x.to(DTYPES[dt]) for x in _device_inputs(
        cuda_device, 21 + b, (b, SERVE_N), (SERVE_N, 50)))
    ops.reset_launches()
    got = ops.ts_matmul(C, W)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == _launches(ts_matmul=1)
    _assert_scaled(got.cpu(), ref.ts_matmul(C, W).cpu(), TOL[dt])
    assert torch.equal(got, ops.ts_matmul(C, W))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", REDESIGN_MN)
@pytest.mark.parametrize("k", REDESIGN_K)
@pytest.mark.parametrize("dt", DTYPES)
def test_gram_and_ts_matmul_over_k_and_unaligned_rows(cuda_device, m, n, k,
                                                      dt):
    a, b, w = _inputs(22, (m, n), (n, k), (m, k))
    A, B, W = (torch.from_numpy(x).to(cuda_device, DTYPES[dt])
               for x in (a, b, w))
    for A_, B_, W_ in ((A, B, W), (_off_grid(A), _off_grid(B), _off_grid(W))):
        for got, want in ((ops.ts_matmul(A_, B_), ref.ts_matmul(A_, B_)),
                          (ops.gram(W_), ref.gram(W_)),
                          (ops.gram(B_), ref.gram(B_))):
            torch.cuda.synchronize()
            _assert_scaled(got.cpu(), want.cpu(), TOL[dt])
        G = ops.gram(B_)
        assert torch.equal(G, G.T) and torch.equal(G, ops.gram(B_))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [13_824, 1_013_400])
@pytest.mark.parametrize("dt", DTYPES)
def test_gram_is_exactly_symmetric_and_bit_reproducible(cuda_device, r, dt):
    (X,) = _device_inputs(cuda_device, 23, (r, 50))
    X = X.to(DTYPES[dt])
    G = ops.gram(X)
    torch.cuda.synchronize()
    assert torch.equal(G, G.T)
    assert torch.equal(G, ops.gram(X))
    _assert_scaled(G.cpu(), ref.gram(X).cpu(), TOL[dt])
    main, reduce = ops.gram_parts(X)          # the two launches, apart
    main()
    assert torch.equal(reduce(), G)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(256, SERVE_N), (20_000, 13_824)])
def test_ts_matmul_is_bit_reproducible(cuda_device, m, n):
    A, B = _device_inputs(cuda_device, 24, (m, n), (n, 50))
    assert torch.equal(ops.ts_matmul(A, B), ops.ts_matmul(A, B))


# LUC launches per iteration of a 3-iteration fit (amu/ahals: inner_iters=2,
# delta=0, so exactly 2 sweeps per half)
LUC_PER_ITER = {"mu": {"mu_update": 2},
                "hals": {"hals_sweep": 1, "hals_sweep_norm": 1},
                "bpp": {}, "amu": {"mu_update": 4},
                "ahals": {"hals_sweep": 2, "hals_sweep_norm": 2}}


def _algo(name):
    if name in ("amu", "ahals"):
        return type(rules.get_rule(name))(inner_iters=2, delta=0.0)
    return name


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["mu", "hals", "bpp", "amu", "ahals"])
def test_fit_on_the_card_matches_the_cpu_path(cuda_device, algo):
    rng = np.random.default_rng(9)
    m, n, k = 96, 64, 6
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + 0.5 * rng.uniform(size=(m, n))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    ops.reset_launches()
    res = NMFSolver(k, algo=_algo(algo), max_iters=3).fit(A, W0=W0, H0=H0)
    luc = {name: 3 * c for name, c in LUC_PER_ITER[algo].items()}
    assert ops.LAUNCHES == _launches(gram=9, ts_matmul=3, ts_matmul_t=3,
                                     **luc)
    assert res.W.is_cuda and res.extras["backend"] == "cuda"
    cpu = NMFSolver(k, algo=_algo(algo), device="cpu", max_iters=3).fit(
        A, W0=W0, H0=H0)
    assert res.extras["rule_state"] == cpu.extras["rule_state"]
    np.testing.assert_allclose(res.rel_errors.numpy(),
                               cpu.rel_errors.numpy(), rtol=1e-4)
    _assert_scaled(res.W.cpu(), cpu.W, 1e-4)
    _assert_scaled(res.H.cpu(), cpu.H, 1e-4)


# Sparse shapes (m, n, k, density): test_spmm.py's sizes, a hot row with
# empty tiles, every axis ragged, and k > 128 (a second column panel).
SPARSE_SHAPES = [(64, 48, 8, 0.25), (40, 24, 5, 0.0), (100, 70, 10, 0.1),
                 (4_099, 1_001, 70, 0.002), (300, 200, 130, 0.05)]


def _sparse_problem(seed, m, n, k, density):
    """A with a hot row (row 3 full) and, below row 8, only the density's
    nonzeros (so most tiles of the sparse shapes are empty); B (n, k) and
    C (m, k) uniform."""
    rng = np.random.default_rng(seed)
    A = (rng.uniform(size=(m, n)) * (rng.uniform(size=(m, n)) < density))
    A[3] = rng.uniform(size=n)
    return (A.astype(np.float32), rng.uniform(size=(n, k)).astype(np.float32),
            rng.uniform(size=(m, k)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,density", SPARSE_SHAPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_spmm_kernels_match_plain_versions(cuda_device, m, n, k, density,
                                           dt):
    a, b, c = _sparse_problem(5, m, n, k, density)
    A = torch.from_numpy(a).to(DTYPES[dt])
    cpu = blocksparse.blockify(A, 1, 1).sort_rows(align=16)
    blk = blocksparse.blockify(A.to(cuda_device), 1, 1).sort_rows(align=16)
    for f in blocksparse.LEAVES:          # the layout built on the card
        assert torch.equal(getattr(blk, f).cpu(), getattr(cpu, f)), f
    B, C = (torch.from_numpy(x).to(cuda_device, DTYPES[dt]) for x in (b, c))
    ops.reset_launches()
    for impl in ("cuda", "sorted"):
        for got, want in ((blocksparse.local_spmm(blk, B, impl=impl),
                           blocksparse.local_spmm(blk, B, impl="scatter")),
                          (blocksparse.local_spmm_t(blk, C, impl=impl),
                           blocksparse.local_spmm_t(blk, C, impl="scatter"))):
            torch.cuda.synchronize()
            assert got.dtype == torch.float32 and got.is_cuda
            _assert_scaled(got.cpu(), want.cpu(), TOL[dt])
    assert ops.LAUNCHES["spmm"] == 2 and ops.LAUNCHES["spmm_sorted"] == 2
    empty = (A.abs().sum(1) == 0).to(cuda_device)   # rows without nonzeros
    assert not blocksparse.local_spmm(blk, B, impl="sorted")[empty].any()


@pytest.mark.cuda
def test_spmm_sorted_is_bit_identical_across_runs(cuda_device):
    a, b, _ = _sparse_problem(8, 20_000, 3_000, 50, 0.003)
    blk = blocksparse.blockify(torch.from_numpy(a).to(cuda_device), 1,
                               1).sort_rows()
    B = torch.from_numpy(b).to(cuda_device)
    first = blocksparse.local_spmm(blk, B, impl="sorted")
    assert torch.equal(first, blocksparse.local_spmm(blk, B, impl="sorted"))


@pytest.mark.cuda
def test_spmm_sorted_refuses_a_tile_out_of_row_order(cuda_device):
    """The kernel needs each tile's rows in order: a layout without cached
    first units is checked and a row that comes back is refused, where
    sort_rows' layout is taken; on the CPU the plain version takes both."""
    a = np.zeros((24, 24), np.float32)
    a[1, 2], a[3, 4], a[3, 9], a[9, 0], a[20, 5] = 1, 2, 3, 4, 5
    blk = blocksparse.blockify(torch.from_numpy(a).to(cuda_device), 1,
                               1).sort_rows(align=8)
    v, r, c, tiles, valid = (t.reshape(-1) for t in (
        blk.vals, blk.rows, blk.cols, blk.row_tiles, blk.row_valid))
    B = torch.rand(24, 4, device=cuda_device)
    got = ops.spmm_sorted(v, r, c, tiles, valid, B, 24, align=8)
    torch.testing.assert_close(got, torch.from_numpy(a).to(cuda_device) @ B)
    live = [i for i in range(r.numel())
            if i % 8 < valid[i // 8] and tiles[i // 8] == 0]
    order = torch.tensor([live[2], live[1], live[0]], device=cuda_device)
    at = torch.tensor(live, device=cuda_device)
    v2, r2, c2 = v.clone(), r.clone(), c.clone()
    for new, old in ((v2, v), (r2, r), (c2, c)):
        new[at] = old[order]             # the same triplets, rows 3, 3, 1
    with pytest.raises(ValueError, match="row order"):
        ops.spmm_sorted(v2, r2, c2, tiles, valid, B, 24, align=8)
    plain = ops.spmm_sorted(*(t.cpu() for t in (v2, r2, c2, tiles, valid,
                                                B)), 24, align=8)
    torch.testing.assert_close(plain, got.cpu())


@pytest.mark.cuda
def test_spmm_wrappers_refuse_strided_or_mixed_dtype(cuda_device):
    blk = blocksparse.blockify(torch.eye(16, device=cuda_device), 1,
                               1).sort_rows(align=8)
    v, r, c = (t.reshape(-1) for t in (blk.vals, blk.rows, blk.cols))
    B = torch.rand(16, 4, device=cuda_device)
    with pytest.raises(ValueError):                  # strided B (a Hᵀ view)
        ops.spmm(v, r, c, torch.rand(4, 16, device=cuda_device).T, 16)
    with pytest.raises(ValueError):                  # bf16 vals, fp32 B
        ops.spmm(v.bfloat16(), r, c, B, 16)
    with pytest.raises(ValueError):
        ops.spmm_sorted(v, r, c, blk.row_tiles.reshape(-1),
                        blk.row_valid.reshape(-1), B.bfloat16(), 16, align=8)
    with pytest.raises(TypeError):                   # int64 indices
        ops.spmm(v, r.long(), c, B, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["sorted", "auto"])
@pytest.mark.parametrize("algo", ["mu", "hals", "bpp"])
def test_sparse_fit_on_the_card_matches_the_cpu_path(cuda_device, algo,
                                                      impl):
    rng = np.random.default_rng(10)
    m, n, k = 96, 64, 6
    A = (rng.uniform(size=(m, n)) * (rng.uniform(size=(m, n)) < 0.3)
         ).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    ops.reset_launches()
    res = NMFSolver(k, algo=algo, backend=SparseOps(spmm_impl=impl),
                    max_iters=3).fit(A, W0=W0, H0=H0)
    kernel = "spmm_sorted" if impl == "sorted" else "spmm"
    luc = {name: 3 * c for name, c in LUC_PER_ITER[algo].items()}
    assert ops.LAUNCHES == _launches(**{kernel: 6}, **luc)
    assert res.W.is_cuda and res.extras["backend"] == "sparse"
    cpu = NMFSolver(k, algo=algo, backend="sparse", device="cpu",
                    max_iters=3).fit(A, W0=W0, H0=H0)
    np.testing.assert_allclose(res.rel_errors.numpy(),
                               cpu.rel_errors.numpy(), rtol=1e-4)
    _assert_scaled(res.W.cpu(), cpu.W, 1e-4)
    _assert_scaled(res.H.cpu(), cpu.H, 1e-4)


# LUC shapes (r, k): test_kernels.py's, ragged r at the main path's width, k
# = 1 and k = 128, and a 65,536-row slice
LUC_SHAPES = [(64, 8), (100, 10), (128, 50), (4_099, 50), (4_099, 1),
              (4_099, 128), (1, 70), (65_536, 50)]
# (X dtype, R dtype): an fp32 carry, a bf16 carry with fp32 R from the
# products, and all-bf16
LUC_DTYPES = {"f32": (torch.float32, torch.float32),
              "bf16_f32": (torch.bfloat16, torch.float32),
              "bf16": (torch.bfloat16, torch.bfloat16)}


def _luc_problem(seed, r, k):
    """X with a zero row (X·G = 0: the ε guard), G a Gram with a zero
    diagonal entry when k > 2, R."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(r, k)).astype(np.float32)
    X[r // 2] = 0.0
    C = rng.uniform(size=(30, k)).astype(np.float32)
    if k > 2:
        C[:, 2] = 0.0
    R = rng.uniform(size=(r, k)).astype(np.float32) * 5
    return X, C.T @ C, R


@pytest.mark.cuda
@pytest.mark.parametrize("eps", ["fixed", "eps_for"])
@pytest.mark.parametrize("r,k", LUC_SHAPES)
@pytest.mark.parametrize("dt", LUC_DTYPES)
def test_luc_kernels_match_plain_versions(cuda_device, r, k, dt, eps):
    x, g, rr = _luc_problem(11, r, k)
    xdt, rdt = LUC_DTYPES[dt]
    X = torch.from_numpy(x).to(cuda_device, xdt)
    G = torch.from_numpy(g).to(cuda_device)
    R = torch.from_numpy(rr).to(cuda_device, rdt)
    e = ref.LUC_EPS if eps == "fixed" else rules.eps_for(xdt)
    ops.reset_launches()
    for name in ("mu_update", "hals_sweep"):
        got = getattr(ops, name)(X, G, R, eps=e)
        want = getattr(ref, name)(X, G, R, e)
        torch.cuda.synchronize()
        assert got.dtype == xdt and got.is_cuda
        assert torch.isfinite(got.float()).all()
        _assert_scaled(got.float().cpu(), want.float().cpu(),
                       TOL["f32" if dt == "f32" else "bf16"])
    assert ops.LAUNCHES == _launches(mu_update=1, hals_sweep=1)


@pytest.mark.cuda
def test_hals_sweep_kernel_is_sequential(cuda_device):
    x, g, rr = (torch.from_numpy(a).to(cuda_device)
                for a in _luc_problem(12, 40, 6))
    seq = ops.hals_sweep(x, g, rr)
    jacobi = torch.clamp_min(x + (rr - x @ g) / torch.clamp_min(
        torch.diagonal(g), ref.LUC_EPS), 0.0)
    assert not torch.allclose(seq, jacobi, atol=1e-5)
    _assert_scaled(seq.cpu(), ref.hals_sweep(x, g, rr).cpu(), 1e-5)


@pytest.mark.cuda
def test_luc_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    X = torch.rand(64, 8, device=cuda_device)
    with pytest.raises(TypeError):
        ops.hals_sweep(X, torch.rand(8, 8, device=cuda_device).bfloat16(), X)
    with pytest.raises(ValueError):
        ops.hals_sweep(X, torch.rand(8, 8), X)          # G on the CPU


# Wide k: hals_sweep's column-blocked kernel with G restaged per block of
# columns (160, 256) and its row-per-warp kernel (1,000, where no tile
# fits), and mu_update's plans with G whole (129, 160), in column chunks
# (256 fp32, 1,000) and the row-per-warp MU kernel (2,100 fp32)
WIDE_K = [129, 160, 256, 1_000]


def _hals_kernel_name(X, R):
    """The LAUNCHES name of hals_sweep on X and R: the column-blocked
    kernel, or the row-per-warp one where its plan takes it."""
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    plan = ops.plan_hals_sweep(X.shape[0], X.shape[1], X.element_size(), sms,
                               r_itemsize=R.element_size())
    return "hals_sweep" if plan.rows else "hals_sweep_wide"


@pytest.mark.cuda
@pytest.mark.parametrize("k", WIDE_K)
@pytest.mark.parametrize("dt", LUC_DTYPES)
def test_luc_kernels_at_wide_k_match_plain_versions(cuda_device, k, dt):
    x, g, rr = _luc_problem(14, 301, k)
    xdt, rdt = LUC_DTYPES[dt]
    X = torch.from_numpy(x).to(cuda_device, xdt)
    G = torch.from_numpy(g).to(cuda_device)
    R = torch.from_numpy(rr).to(cuda_device, rdt)
    e = rules.eps_for(xdt)
    ops.reset_launches()
    for name in ("mu_update", "hals_sweep"):
        got = getattr(ops, name)(X, G, R, eps=e)
        want = getattr(ref, name)(X, G, R, e)
        torch.cuda.synchronize()
        assert got.dtype == xdt and torch.isfinite(got.float()).all()
        # column by column: the ε-divided column cannot hide the others
        for j in range(k):
            _assert_scaled(got[:, j].float().cpu(), want[:, j].float().cpu(),
                           TOL["f32" if dt == "f32" else "bf16"])
        assert torch.equal(got, getattr(ops, name)(X, G, R, eps=e))
    assert ops.LAUNCHES == _launches(mu_update=2,
                                     **{_hals_kernel_name(X, R): 2})


def _mu_plans(r, k, size, sms):
    """The default plan, other tiles (G whole; an fp32 X read in place and
    widened), G forced into column chunks, and the row-per-warp kernel,
    for mu_update on (r, k)."""
    plans = [ops.plan_mu_update(r, k, size, sms)]
    for rows, stages, direct in ((128, 2, size == 4), (128, 2, False),
                                 (32, 1, False), (64, 3, False)):
        smem = ops.mu_smem(k, rows, stages, k, size, 4, direct)
        plans.append(ops.MuPlan(rows, stages, k, rows // ops.MU_ROW_SLICES,
                                min(-(-r // rows), sms), smem, direct))
    for chunk in (4, 12):
        smem = ops.mu_smem(k, 32, 2, chunk, size, 4)
        plans.append(ops.MuPlan(32, 2, chunk, 1, 5, smem))
    plans.append(ops.MuPlan(0, 0, 0, 0, 7, 0))
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("r,k", [(4_099, 50), (301, 7), (1, 70), (1_000, 1)])
@pytest.mark.parametrize("dt", ["f32", "bf16_f32"])
def test_mu_update_plans_give_the_same_bits(cuda_device, r, k, dt):
    """Every plan sums (X·G)_j over l in order: the same bits, for 16- and
    4-byte copies (a view one element off the grid) alike."""
    x, g, rr = _luc_problem(15, r, k)
    xdt, rdt = LUC_DTYPES[dt]
    X = torch.from_numpy(x).to(cuda_device, xdt)
    G = torch.from_numpy(g).to(cuda_device)
    R = torch.from_numpy(rr).to(cuda_device, rdt)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    first = ops.mu_update(X, G, R)
    _assert_scaled(first.float().cpu(), ref.mu_update(X, G, R).float().cpu(),
                   TOL["f32" if dt == "f32" else "bf16"])
    for plan in _mu_plans(r, k, X.element_size(), sms):
        for X_, R_ in ((X, R), (_off_grid(X), _off_grid(R))):
            assert torch.equal(ops.mu_update(X_, G, R_, plan=plan), first), \
                plan


@pytest.mark.cuda
@pytest.mark.parametrize("dt", LUC_DTYPES)
def test_mu_update_row_per_warp_kernel_past_the_plans(cuda_device, dt):
    x, g, rr = _luc_problem(16, 37, 2_100)
    xdt, rdt = LUC_DTYPES[dt]
    X = torch.from_numpy(x).to(cuda_device, xdt)
    G = torch.from_numpy(g).to(cuda_device)
    R = torch.from_numpy(rr).to(cuda_device, rdt)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if dt == "f32":
        assert ops.plan_mu_update(37, 2_100, 4, sms).rows == 0
    got = ops.mu_update(X, G, R, plan=ops.MuPlan(0, 0, 0, 0, 3, 0))
    torch.cuda.synchronize()
    _assert_scaled(got.float().cpu(), ref.mu_update(X, G, R).float().cpu(),
                   TOL["f32" if dt == "f32" else "bf16"])
    assert torch.equal(got, ops.mu_update(X, G, R))


# hals_sweep's column-blocked kernel: k not a multiple of its 16-column
# blocks, below one block, both sides of 128, G whole and restaged, and
# the row-per-warp kernel where no tile fits (1,000 fp32)
HALS_K = [1, 7, 16, 50, 64, 100, 128, 129, 160, 256, 1_000]


def _assert_hals(got, want, X, G, R, eps, dt):
    """hals_sweep's kernel result against ``want`` (the plain version, or
    another kernel): fp32 within 1e-5 on the sweep's scale, bf16 within
    2e-2 column by column (a bf16 output's rounding is relative to itself,
    not to the sums); and either against float64 sums on the sweep's
    scale."""
    tol = TOL["f32" if dt == "f32" else "bf16"]
    if dt == "f32":
        assert ref.sweep_scaled_err(got, want, X, G, R, eps) <= tol
    else:
        for j in range(got.shape[1]):
            _assert_scaled(got[:, j].float().cpu(), want[:, j].float().cpu(),
                           tol)
    assert ref.sweep_scaled_err(got, ref.hals_sweep_f64(X, G, R, eps), X, G,
                                R, eps) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("k", HALS_K)
@pytest.mark.parametrize("r", [37, 1_003])
@pytest.mark.parametrize("dt", LUC_DTYPES)
def test_hals_sweep_over_k_against_plain_and_float64(cuda_device, k, r, dt):
    """fp32 within 1e-5 on the sweep's scale of both the plain version and
    float64 sums; bf16 within 2e-2 of the plain version column by column
    (a bf16 output's rounding is relative to itself, not to the sums) and
    of float64 sums on the sweep's scale; identical bits across runs."""
    x, g, rr = _luc_problem(21, r, k)
    xdt, rdt = LUC_DTYPES[dt]
    X = torch.from_numpy(x).to(cuda_device, xdt)
    G = torch.from_numpy(g).to(cuda_device)
    R = torch.from_numpy(rr).to(cuda_device, rdt)
    eps = rules.eps_for(xdt)
    name = _hals_kernel_name(X, R)
    assert name == "hals_sweep" or k > 256
    ops.reset_launches()
    got = ops.hals_sweep(X, G, R, eps=eps)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == _launches(**{name: 1})
    assert got.dtype == xdt and torch.isfinite(got.float()).all()
    _assert_hals(got, ref.hals_sweep(X, G, R, eps), X, G, R, eps, dt)
    assert torch.equal(got, ops.hals_sweep(X, G, R, eps=eps))


def _hals_plans(r, k, size, r_size, sms):
    """The default plan and other tiles that fit: each count of threads a
    row and of stages, G whole and restaged, an fp32 X swept in place and
    widened."""
    plans = [ops.plan_hals_sweep(r, k, size, sms, r_itemsize=r_size)]
    nb = -(-k // ops.HALS_BLOCK)
    for rows, tpr in ((32, 1), (32, 4), (128, 1), (64, 4), (256, 1)):
        for stages in (1, 2, 3):
            for gblocks in dict.fromkeys((nb, 1)):
                for direct in dict.fromkeys((False, plans[0].direct)):
                    smem = ops.hals_smem(k, rows, stages, gblocks, size,
                                         r_size, direct)
                    if smem <= ops.SMEM_PER_BLOCK:
                        plans.append(ops.HalsPlan(rows, stages, gblocks, tpr,
                                                  5, smem, direct))
    return plans


@pytest.mark.cuda
@pytest.mark.parametrize("r,k", [(4_099, 50), (301, 7), (1, 70), (1_000, 1),
                                 (517, 160), (300, 33)])
@pytest.mark.parametrize("dt", LUC_DTYPES)
def test_hals_sweep_plans_give_the_same_bits(cuda_device, r, k, dt):
    """Every plan sums each P over l in order and sweeps the same blocks:
    the same bits, for 16- and 4-byte copies (a view one element off the
    grid) alike."""
    x, g, rr = _luc_problem(22, r, k)
    xdt, rdt = LUC_DTYPES[dt]
    X = torch.from_numpy(x).to(cuda_device, xdt)
    G = torch.from_numpy(g).to(cuda_device)
    R = torch.from_numpy(rr).to(cuda_device, rdt)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    first = ops.hals_sweep(X, G, R)
    plans = _hals_plans(r, k, X.element_size(), R.element_size(), sms)
    assert len(plans) > 3
    for plan in plans:
        for X_, R_ in ((X, R), (_off_grid(X), _off_grid(R))):
            assert torch.equal(ops.hals_sweep(X_, G, R_, plan=plan),
                               first), plan


@pytest.mark.cuda
def test_hals_sweep_keeps_a_nan(cuda_device):
    x, g, rr = _luc_problem(23, 300, 50)
    x[7, 3] = np.nan
    X, G, R = (torch.from_numpy(a).to(cuda_device) for a in (x, g, rr))
    got, want = ops.hals_sweep(X, G, R), ref.hals_sweep(X, G, R)
    assert torch.isnan(got[7]).all()
    assert torch.equal(torch.isnan(got), torch.isnan(want))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", LUC_DTYPES)
def test_hals_sweep_row_per_warp_kernel_past_the_plans(cuda_device, dt):
    x, g, rr = _luc_problem(24, 45, 1_000)
    xdt, rdt = LUC_DTYPES[dt]
    X = torch.from_numpy(x).to(cuda_device, xdt)
    G = torch.from_numpy(g).to(cuda_device)
    R = torch.from_numpy(rr).to(cuda_device, rdt)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert ops.plan_hals_sweep(45, 1_000, X.element_size(), sms,
                               r_itemsize=R.element_size()).rows == 0
    eps = rules.eps_for(xdt)
    ops.reset_launches()
    got = ops.hals_sweep(X, G, R, eps=eps)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == _launches(hals_sweep_wide=1)
    _assert_hals(got, ref.hals_sweep(X, G, R, eps), X, G, R, eps, dt)
    # the row-per-warp kernel at a k a tile fits, forced
    small = [t[:, :70].contiguous() for t in (X, R)]
    Gs = G[:70, :70].contiguous()
    forced = ops.hals_sweep(small[0], Gs, small[1], eps=eps,
                            plan=ops.HalsPlan(0, 0, 0, 0, 3, 0))
    _assert_hals(forced, ops.hals_sweep(small[0], Gs, small[1], eps=eps),
                 small[0], Gs, small[1], eps, dt)


# hals_sweep_norm, the HALS W-step's normalised sweep, against the plain
# loop (``ref.hals_sweep_norm``) on the card: k below one 8-column block,
# two blocks, ragged blocks, a k past the plans; r not a multiple of the
# head pass's 128-row tile
NORM_K = [1, 16, 50, 70]
NORM_R = [37, 1_003, 65_537]


def _norm_problem(seed, r, k, x_scale=None):
    """X near a planted X* with R = X*·G plus noise, so that the updates
    are mostly positive; for k > 1, column min(3, k − 1)'s R so negative
    that the column clamps to all zeros (its norm 0: the guard keeps it).
    ``x_scale``: X uniform on [0, x_scale) instead, so that X·G is a small
    part of each update and a wide k's sums cancel little."""
    rng = np.random.default_rng(seed)
    C = rng.uniform(size=(30, k)).astype(np.float32)
    G = C.T @ C
    Xs = rng.uniform(size=(r, k)).astype(np.float32)
    R = (Xs @ G + 0.1 * rng.uniform(size=(r, k))).astype(np.float32)
    X = (Xs * rng.uniform(0.5, 1.5, size=(r, k))).astype(np.float32)
    if x_scale is not None:
        X = (x_scale * rng.uniform(size=(r, k))).astype(np.float32)
    if k > 1:
        R[:, min(3, k - 1)] = -1e3
    return X, G, R


def _norm_inputs(device, seed, r, k, dt, x_scale=None):
    x, g, rr = _norm_problem(seed, r, k, x_scale)
    xdt, rdt = LUC_DTYPES[dt]
    return (torch.from_numpy(x).to(device, xdt), torch.from_numpy(g).to(device),
            torch.from_numpy(rr).to(device, rdt))


def _plain_w_sweep(X, G, R, *, eps=ref.LUC_EPS):
    """ops.hals_sweep_norm's stand-in that runs the plain column loop."""
    return ref.hals_sweep_norm(X, G, R, eps)


def _assert_columns(got, want, tol):
    """Each column within ``tol`` of its largest |value| (a normalised
    column's scale is its own); an all-zero column exactly zero."""
    got, want = got.float().cpu(), want.float().cpu()
    scale = want.abs().amax(0)
    err = (got - want).abs().amax(0)
    assert bool((err <= tol * scale).all()), (err / scale.clamp_min(1e-30))


def _norm_plan(device, r, k, head):
    """hals_sweep_norm's plan, or (``head`` "wide") the same with the wide
    head pass that a k past the head pass's tiles takes."""
    plan = ops.plan_hals_sweep_norm(r, k, torch.cuda.get_device_properties(
        device).multi_processor_count)
    if head == "wide":
        plan = plan._replace(rows=0, head_blocks=plan.col_blocks)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("head", ["tiled", "wide"])
@pytest.mark.parametrize("r", NORM_R)
@pytest.mark.parametrize("k", NORM_K)
@pytest.mark.parametrize("dt", LUC_DTYPES)
def test_hals_sweep_norm_matches_the_plain_loop(cuda_device, dt, k, r, head):
    """fp32 within 1e-5 of the plain loop column by column, bf16 within
    2e-2 (one rounding of the carry); the all-zero column stays zero; X is
    not modified; a second run gives the same bits.  On its plan and on
    the wide head pass."""
    X, G, R = _norm_inputs(cuda_device, 31, r, k, dt)
    X0 = X.clone()
    eps = rules.eps_for(X.dtype)
    plan = _norm_plan(cuda_device, r, k, head)
    ops.reset_launches()
    got = ops.hals_sweep_norm(X, G, R, eps=eps, plan=plan)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == _launches(hals_sweep_norm=1)
    assert got.dtype == X.dtype and got.is_cuda
    assert torch.isfinite(got.float()).all() and got.min() >= 0
    want = ref.hals_sweep_norm(X, G, R, eps)
    _assert_columns(got, want, TOL["f32" if dt == "f32" else "bf16"])
    if k > 1:
        assert not got[:, min(3, k - 1)].any()
    assert torch.equal(X, X0)
    assert torch.equal(got, ops.hals_sweep_norm(X, G, R, eps=eps, plan=plan))


@pytest.mark.cuda
def test_hals_sweep_norm_uses_no_tf32_and_keeps_a_nan(cuda_device):
    """The sweep's sums are fp32 FMAs whatever the TF32 switches say; a NaN
    in a row reaches that row's later columns and its column's norm (the
    column then keeps its values, as the plain loop's guard does)."""
    X, G, R = _norm_inputs(cuda_device, 32, 4_099, 50, "f32")
    want = ops.hals_sweep_norm(X, G, R)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        assert torch.equal(ops.hals_sweep_norm(X, G, R), want)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    X[7, 5] = float("nan")
    got, plain = ops.hals_sweep_norm(X, G, R), ref.hals_sweep_norm(X, G, R)
    assert torch.equal(torch.isnan(got), torch.isnan(plain))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", LUC_DTYPES)
def test_w_step_past_the_plans_runs_the_wide_head_pass(cuda_device, dt):
    """k = 1,460: no head-pass tile fits, so the rule's W-step runs the
    kernel with its wide head pass (one launch), within the plain loop's
    tolerance on a problem whose sums cancel little, the same bits twice;
    float64 on the card is refused, as by the other LUC wrappers."""
    X, G, R = _norm_inputs(cuda_device, 33, 1_003, 1_460, dt, x_scale=0.05)
    assert ops.hals_norm_rows(1_460) == 0
    ops.reset_launches()
    got = rules.update_hals(G, R, X, normalize=True)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == _launches(hals_sweep_norm=1)
    eps = rules.eps_for(X.dtype)
    _assert_columns(got, ref.hals_sweep_norm(X, G, R, eps),
                    TOL["f32" if dt == "f32" else "bf16"])
    assert not got[:, 3].any()
    assert torch.equal(got, ops.hals_sweep_norm(X, G, R, eps=eps))
    X64, G64, R64 = (t[:, :50].double().contiguous() for t in (X, G, R))
    G64 = G64[:50].contiguous()
    with pytest.raises(TypeError):
        rules.update_hals(G64, R64, X64, normalize=True)


@pytest.mark.cuda
def test_w_step_takes_the_kernel_only_without_a_reduction(cuda_device):
    """``norm_psum`` left at None (one device holds every row) runs
    hals_sweep_norm; a reduction over ranks (any callable) the plain
    loop."""
    X, G, R = _norm_inputs(cuda_device, 34, 1_003, 50, "f32")
    ops.reset_launches()
    kern = rules.update_hals(G, R, X, normalize=True)
    assert ops.LAUNCHES == _launches(hals_sweep_norm=1)
    ops.reset_launches()
    loop = rules.update_hals(G, R, X, normalize=True, norm_psum=lambda v: v)
    assert ops.LAUNCHES == _launches()
    assert torch.equal(loop, ref.hals_sweep_norm(X, G, R,
                                                 rules.eps_for(X.dtype)))
    _assert_columns(kern, loop, TOL["f32"])


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["hals", "ahals"])
def test_hals_fits_with_the_w_kernel_match_the_plain_loop(cuda_device,
                                                          algo):
    """Serial hals and ahals on the card, the W-step through
    hals_sweep_norm, against the same fits with the plain loop: the
    rel-error trajectories at 1e-4, the factors after one iteration at
    1e-4 (scaled) and after three at 1e-3 (HALS clamps part of W to 0
    there, so rounding moves later iterations)."""
    rng = np.random.default_rng(35)
    m, n, k = 4_099, 1_001, 50
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + 0.5 * rng.uniform(size=(m, n))).astype(np.float32)
    for iters, tol in ((1, 1e-4), (3, 1e-3)):
        ops.reset_launches()
        got = NMFSolver(k, algo=_algo(algo), max_iters=iters).fit(A, seed=3)
        assert ops.LAUNCHES["hals_sweep_norm"] == \
            iters * LUC_PER_ITER[algo]["hals_sweep_norm"]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ops, "hals_sweep_norm", _plain_w_sweep)
            ops.reset_launches()
            want = NMFSolver(k, algo=_algo(algo), max_iters=iters).fit(
                A, seed=3)
            assert ops.LAUNCHES["hals_sweep_norm"] == 0
        np.testing.assert_allclose(got.rel_errors.numpy(),
                                   want.rel_errors.numpy(), rtol=1e-4)
        _assert_scaled(got.W.cpu(), want.W.cpu(), tol)
        _assert_scaled(got.H.cpu(), want.H.cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["mu", "hals", "amu", "ahals"])
def test_wide_k_fit_on_the_card_matches_the_cpu_path(cuda_device, algo):
    """k = 160 through the LUC kernels (G restaged or chunked).  The
    rel-error trajectories of 3 iterations and the factors after one agree
    at 1e-4, the factors after 3 too for the MU rules.  HALS clamps 59 % of
    W to 0 by its third iteration here, so its factors then move with
    rounding: a 1-ulp change of A moves the CPU path's W by 7e-7 after one
    iteration and by 1.6e-3 after three."""
    rng = np.random.default_rng(17)
    m, n, k = 400, 300, 160
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + 0.5 * k * rng.uniform(size=(m, n))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    for iters in (1, 3):
        ops.reset_launches()
        res = NMFSolver(k, algo=_algo(algo), max_iters=iters).fit(
            A, W0=W0, H0=H0)
        luc = {name: iters * c for name, c in LUC_PER_ITER[algo].items()}
        assert ops.LAUNCHES == _launches(gram=3 * iters, ts_matmul=iters,
                                         ts_matmul_t=iters, **luc)
        cpu = NMFSolver(k, algo=_algo(algo), device="cpu",
                        max_iters=iters).fit(A, W0=W0, H0=H0)
        assert res.extras["rule_state"] == cpu.extras["rule_state"]
        np.testing.assert_allclose(res.rel_errors.numpy(),
                                   cpu.rel_errors.numpy(), rtol=1e-4)
        if iters == 1 or algo in ("mu", "amu"):
            _assert_scaled(res.W.cpu(), cpu.W, 1e-4)
            _assert_scaled(res.H.cpu(), cpu.H, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,kernel,k", [
    pytest.param("mu", "mu_update", 160, id="mu-mu_update"),
    pytest.param("hals", "hals_sweep", 160, id="hals-hals_sweep"),
    # fp32 k = 520: no tile of the column-blocked kernel fits, so each
    # sweep runs the row-per-warp kernel (as chip_smoke.py phase 8c serves)
    pytest.param("hals", "hals_sweep_wide", 520,
                 id="hals-hals_sweep_wide")])
def test_wide_k_foldin_on_the_card_matches_the_cpu(cuda_device, algo,
                                                   kernel, k):
    rng = np.random.default_rng(18)
    W = rng.uniform(size=(500, k)).astype(np.float32)
    H = rng.uniform(size=(k, max(400, 2 * k))).astype(np.float32)
    rows = (rng.uniform(size=(7, k)) @ H).astype(np.float32)
    proj = FoldInProjector(FactorArtifact.from_factors(
        W, H, algo="bpp", device=cuda_device), algo=algo, iters=20)
    ops.reset_launches()
    got = proj.project(torch.from_numpy(rows))
    torch.cuda.synchronize()
    assert ops.LAUNCHES == _launches(ts_matmul=1, **{kernel: 20})
    want = FoldInProjector(FactorArtifact.from_factors(W, H, device="cpu"),
                           algo=algo, iters=20, device="cpu").project(rows)
    _assert_scaled(got.cpu(), want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("algo,kernel", [("mu", "mu_update"),
                                         ("hals", "hals_sweep"),
                                         ("amu", "mu_update"),
                                         ("ahals", "hals_sweep"),
                                         ("bpp", None)])
def test_foldin_on_the_card_launches_and_matches_the_cpu(cuda_device, algo,
                                                         kernel):
    rng = np.random.default_rng(13)
    W = rng.uniform(size=(200, 6)).astype(np.float32)
    H = rng.uniform(size=(6, 300)).astype(np.float32)
    rows = (rng.uniform(size=(7, 6)) @ H).astype(np.float32)
    art = FactorArtifact.from_factors(W, H, algo="bpp", device=cuda_device)
    proj = FoldInProjector(art, algo=algo, iters=20)
    for sparse in (False, True):
        req = torch.from_numpy(rows)
        if sparse:
            req = req.to_sparse_coo()
        ops.reset_launches()
        got = proj.project(req)
        torch.cuda.synchronize()
        counts = dict(ops.LAUNCHES)
        assert counts["spmm" if sparse else "ts_matmul"] == 1
        if kernel is None:
            assert counts["mu_update"] == counts["hals_sweep"] == 0
        else:
            assert 1 <= counts[kernel] <= 20
        want = FoldInProjector(FactorArtifact.from_factors(W, H,
                                                           device="cpu"),
                               algo=algo, iters=20,
                               device="cpu").project(rows)
        _assert_scaled(got.cpu(), want, 1e-4)
    vals, idx = TopK(art, chunk=64).query(got, k=3)
    assert idx.is_cuda and idx.shape == (7, 3)


# ts_matmul_t on the tensor cores: k from 1 to 128, A's rows 16-byte aligned
# (n % 4 = 0) or not (4-byte copies), a ragged m, m below one 32-row stage
T_K = [1, 8, 50, 64, 100, 128]
T_MN = [(4_099, 1_024), (20_001, 1_001), (1_003, 301), (17, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", T_MN)
@pytest.mark.parametrize("k", T_K)
@pytest.mark.parametrize("dt", DTYPES)
def test_ts_matmul_t_over_k_and_unaligned_rows(cuda_device, m, n, k, dt):
    a, w = _inputs(25, (m, n), (m, k))
    A, W = (torch.from_numpy(x).to(cuda_device, DTYPES[dt]) for x in (a, w))
    for A_, W_ in ((A, W), (_off_grid(A), _off_grid(W))):
        ops.reset_launches()
        got = ops.ts_matmul_t(A_, W_)
        torch.cuda.synchronize()
        assert ops.LAUNCHES == _launches(ts_matmul_t=1)
        assert got.dtype == torch.float32 and got.shape == (n, k)
        _assert_scaled(got.cpu(), ref.ts_matmul_t(A_, W_).cpu(), TOL[dt])
        # the inputs as the kernel reads them, multiplied in float64: only
        # the kernel's fp32 sums differ from it
        want = A_.double().T @ W_.double()
        _assert_scaled(got.cpu(), want.cpu(), 1e-5)
        assert torch.equal(got, ops.ts_matmul_t(A_, W_))


def _triplets(seed, m, n, nnz, *, hot=False, dup=False, outside=0):
    """nnz COO triplets of an (m, n) matrix in random order: all in row 0
    (hot), or drawn with repeats (dup), plus ``outside`` triplets whose row
    or column lies outside it; returns (vals, rows, cols, kept), kept
    masking the in-range ones."""
    rng = np.random.default_rng(seed)
    rows = np.zeros(nnz, np.int64) if hot else rng.integers(0, m, nnz)
    cols = rng.integers(0, n, nnz)
    if dup and nnz:
        rows[nnz // 2:] = rows[:nnz - nnz // 2]
        cols[nnz // 2:] = cols[:nnz - nnz // 2]
    if outside:
        rows = np.concatenate([rows, rng.choice([-1, m, m + 7], outside)])
        cols = np.concatenate([cols, rng.integers(0, n, outside)])
        rows = np.concatenate([rows, rng.integers(0, m, outside)])
        cols = np.concatenate([cols, rng.choice([-3, n, n + 1], outside)])
    vals = rng.uniform(size=rows.size).astype(np.float32)
    kept = (rows >= 0) & (rows < m) & (cols >= 0) & (cols < n)
    return vals, rows.astype(np.int32), cols.astype(np.int32), kept


# (m, n, k, nnz, case): odd k (scalar reductions), one hot row, duplicates,
# out-of-range triplets, nnz = 0, an output past the default bucketing
# threshold (100,000 × 50 fp32: 20 MB, both products), the served b = 1
# shape
SPMM_CASES = [(3_001, 2_003, 51, 40_000, "odd k"),
              (3_001, 2_003, 50, 20_000, "hot"),
              (3_001, 2_003, 50, 20_000, "dup"),
              (3_001, 2_003, 70, 20_000, "outside"),
              (3_001, 2_003, 50, 0, "empty"),
              (100_000, 100_000, 50, 800_000, "past threshold"),
              (1, 1_000_000, 50, 9, "served b=1")]


def _many_buckets(nnz, m_out, k, size, sms):
    """The L2-blocked scatter with at least 37 buckets (buckets of the most
    rows, a power of two, that m_out // 37 holds), so a small output still
    crosses many bucket edges; one pass where no two buckets exist."""
    shift = max(1, m_out // 37).bit_length() - 1
    buckets = -(-m_out // (1 << shift))
    if nnz == 0 or buckets == 1:
        return ops.plan_spmm(nnz, m_out, k, size, sms, bucketed=True)
    return ops.SpmmPlan(buckets, shift, ops.SPMM_BUCKET_RUN,
                        ops.SPMM_BUCKET_BLOCKS_PER_SM * sms, nnz * (8 + size))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,nnz,case", SPMM_CASES)
@pytest.mark.parametrize("dt", DTYPES)
def test_spmm_both_products_both_plans(cuda_device, m, n, k, nnz, case, dt):
    vals, rows, cols, kept = _triplets(
        31, m, n, nnz, hot=case == "hot", dup=case == "dup",
        outside=50 if case == "outside" else 0)
    v, r, c = (torch.from_numpy(x).to(cuda_device)
               for x in (vals, rows, cols))
    v = v.to(DTYPES[dt])
    keep = torch.from_numpy(kept).to(cuda_device)
    B, C = (x.to(DTYPES[dt]) for x in _device_inputs(
        cuda_device, 32, (n, k), (m, k)))
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    size = B.element_size()
    for name, call, want, (m_out, rhs) in (
            ("A·B", ops.spmm, ref.spmm(v[keep], r[keep], c[keep], B, m),
             (m, B)),
            ("Aᵀ·C", ops.spmm_t, ref.spmm(v[keep], c[keep], r[keep], C, n),
             (n, C))):
        plans = [None, ops.plan_spmm(v.numel(), m_out, k, size, sms,
                                     bucketed=False),
                 _many_buckets(v.numel(), m_out, k, size, sms)]
        if plans[2].buckets > 1:
            assert plans[2].buckets >= 37 or m_out < 37
        for plan in plans:
            ops.reset_launches()
            got = call(v, r, c, rhs, m_out, plan=plan)
            torch.cuda.synchronize()
            assert ops.LAUNCHES == _launches(spmm=1), (name, plan)
            assert got.dtype == torch.float32 and got.shape == (m_out, k)
            _assert_scaled(got.cpu(), want.cpu(), TOL[dt])
            if plan is None:          # the plan the wrapper chose
                chosen = ops.plan_spmm(v.numel(), m_out, k, size, sms)
                if m_out * k * 4 <= ops.SPMM_L2_SHARE:   # served shapes
                    assert chosen.buckets == 1
                if case == "past threshold":
                    assert chosen.buckets > 1


# spmm_sorted on ragged layouts: m not a multiple of 8, empty tiles (rows
# 8–39 have none), a hot row, k from 1 to 130 (odd k: scalar gathers; k >
# 64: more than one column panel)
SORTED_K = [1, 7, 50, 64, 65, 130]


@pytest.mark.cuda
@pytest.mark.parametrize("k", SORTED_K)
@pytest.mark.parametrize("m,n", [(301, 77), (13, 1_000)])
@pytest.mark.parametrize("dt", DTYPES)
def test_spmm_sorted_on_ragged_layouts(cuda_device, m, n, k, dt):
    a, _, _ = _sparse_problem(19, m, n, 1, 0.05)
    a[8:40] = 0.0
    blk = blocksparse.blockify(torch.from_numpy(a).to(cuda_device,
                                                      DTYPES[dt]),
                               1, 1).sort_rows(align=8)
    B, C = (x.to(DTYPES[dt]) for x in _device_inputs(cuda_device, 20,
                                                     (n, k), (m, k)))
    for local, rhs, flat in ((blocksparse.local_spmm, B, "row"),
                             (blocksparse.local_spmm_t, C, "col")):
        ops.reset_launches()
        got = local(blk, rhs, impl="sorted")
        torch.cuda.synchronize()
        assert ops.LAUNCHES == _launches(spmm_sorted=1)
        assert torch.equal(got, local(blk, rhs, impl="sorted"))
        _assert_scaled(got.cpu(), local(blk, rhs, impl="scatter").cpu(),
                       TOL[dt])
        # without the cached first units: computed per call, the same bits
        bare = dataclasses.replace(blk, **{f"{flat}_first": None})
        assert torch.equal(local(bare, rhs, impl="sorted"), got)
    empty = torch.from_numpy(np.abs(a).sum(1) == 0).to(cuda_device)
    assert not blocksparse.local_spmm(blk, B, impl="sorted")[empty].any()


# ---------------------------------------------------------------------------
# The distributed schedules on one card: a one-rank NCCL group
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_group(cuda_device):
    """A one-rank NCCL process group (NCCL puts no two ranks on one card):
    the faun and naive collectives run through NCCL as identities."""
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "sorted"])
@pytest.mark.parametrize("algo", ["mu", "hals", "bpp", "amu", "ahals"])
@pytest.mark.parametrize("schedule", ["faun", "naive"])
def test_one_rank_nccl_schedules_are_serial_bit_for_bit(nccl_group, schedule,
                                                        algo, backend):
    from repro_torch.core.faun import make_faun_grid
    rng = np.random.default_rng(12)
    m, n, k = 1_000, 640, 16
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + 0.5 * rng.uniform(size=(m, n))).astype(np.float32)
    if backend == "sorted":
        A *= rng.uniform(size=(m, n)) < 0.1
    ops_of = (lambda: SparseOps(spmm_impl="sorted")) if backend == "sorted" \
        else (lambda: "cuda")
    kw = dict(schedule=schedule, grid=make_faun_grid(1, 1)) \
        if schedule == "faun" else dict(schedule=schedule)
    ops.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        # the schedules' HALS W-step sums its column norms through a
        # collective, so it runs the plain loop: the serial fit held
        # against them bit for bit runs that loop too
        mp.setattr(ops, "hals_sweep_norm", _plain_w_sweep)
        serial = NMFSolver(k, algo=_algo(algo), backend=ops_of(),
                           max_iters=3).fit(A, seed=5)
    want = dict(ops.LAUNCHES)
    assert want["hals_sweep_norm"] == 0
    ops.reset_launches()
    res = NMFSolver(k, algo=_algo(algo), backend=ops_of(), max_iters=3,
                    **kw).fit(A, seed=5)
    assert ops.LAUNCHES == want
    assert res.W.is_cuda and res.extras["schedule"] == schedule
    for got, ref_ in ((res.W, serial.W), (res.H, serial.H),
                      (res.rel_errors, serial.rel_errors)):
        assert torch.equal(got, ref_)
    assert res.extras["rule_state"] == serial.extras["rule_state"]


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["cuda", "sorted"])
@pytest.mark.parametrize("algo", ["mu", "hals"])
@pytest.mark.parametrize("schedule", ["faun", "naive"])
def test_one_rank_nccl_schedules_hold_no_more_memory_than_serial(
        nccl_group, cuda_device, schedule, algo, backend):
    """At one rank the schedules' collectives copy the panels, and each
    copy must replace a panel the serial step holds, never add to them:
    the fit's peak above what was allocated before it is at most the
    serial fit's (1 MB slack; a W panel is 4 MB, a sparse one 16 MB)."""
    from repro_torch.core.faun import make_faun_grid
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    k = 16
    if backend == "sorted":
        dim = 1 << 18
        idx = torch.randint(0, dim, (2, 10 * dim), generator=gen,
                            device=cuda_device)
        vals = torch.rand(10 * dim, generator=gen, device=cuda_device)
        A = blocksparse.blockify(torch.sparse_coo_tensor(
            idx, vals, (dim, dim)).coalesce(), 1, 1).sort_rows()
    else:
        A = torch.rand((1 << 16, 1024), generator=gen, device=cuda_device)
    ops_of = (lambda: SparseOps(spmm_impl="sorted")) if backend == "sorted" \
        else (lambda: "cuda")
    kw = dict(schedule=schedule, grid=make_faun_grid(1, 1)) \
        if schedule == "faun" else dict(schedule=schedule)

    def peak(**solver_kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = NMFSolver(k, algo=algo, backend=ops_of(), max_iters=3,
                        **solver_kw).fit(A, seed=5)
        torch.cuda.synchronize()
        del res
        return torch.cuda.max_memory_allocated() - base

    serial = peak()
    assert peak(**kw) <= serial + (1 << 20)


@pytest.mark.cuda
def test_ts_matmul_at_a_video_block_of_the_2x2_grid(cuda_device):
    """A_ij of Video on a 2×2 grid, (506,700, 6,912), times the gathered
    panels: H^jᵀ (6,912, 50) and W_i (506,700, 50).  AᵀW contracts
    506,700 rows, past 65,536: held at 1e-4 (chip_smoke.py's tolerance for
    such sums, where cuBLAS splits what the kernel adds in order)."""
    m, n, k = 1_013_400 // 2, 13_824 // 2, 50
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    A = torch.rand((m, n), generator=gen, device=cuda_device)
    Ht = torch.rand((n, k), generator=gen, device=cuda_device)
    W = torch.rand((m, k), generator=gen, device=cuda_device)
    ops.reset_launches()
    got, got_t = ops.ts_matmul(A, Ht), ops.ts_matmul_t(A, W)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == _launches(ts_matmul=1, ts_matmul_t=1)
    _assert_scaled(got.cpu(), ref.ts_matmul(A, Ht).cpu(), TOL["f32"])
    _assert_scaled(got_t.cpu(), ref.ts_matmul_t(A, W).cpu(), 1e-4)


# ---------------------------------------------------------------------------
# The profiler, the data generators, mesh serving and the autotuned tile
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["mu", "hals", "bpp", "amu", "ahals"])
@pytest.mark.parametrize("backend", ["cuda", "sorted"])
def test_profiled_fit_launches_the_unprofiled_kernels(cuda_device, algo,
                                                      backend):
    """fit(profile=True) on the card: the unprofiled fit's bits, and its
    kernels as many times, plus its untimed warm-up pass's (the first
    iteration's)."""
    from repro_torch.obs.phases import expected_phases
    a, w0, h0 = _inputs(21, (2_048, 1_536), (2_048, 16), (16, 1_536))
    if backend == "sorted":
        A = blocksparse.blockify(torch.from_numpy(a * (a > 0.9)).to(
            cuda_device), 1, 1)
        be = SparseOps(spmm_impl="sorted")
    else:
        A, be = torch.from_numpy(a).to(cuda_device), "cuda"
    def launches(iters, **kw):
        ops.reset_launches()
        res = NMFSolver(16, algo=algo, backend=be, max_iters=iters).fit(
            A, W0=w0 + 0.1, H0=h0, **kw)
        torch.cuda.synchronize()
        return res, dict(ops.LAUNCHES)

    plain, want = launches(3)
    _, first = launches(1)
    prof, got = launches(3, profile=True)
    assert got == {name: want[name] + first[name] for name in want}
    assert sum(want.values()) > 0
    assert torch.equal(prof.W, plain.W) and torch.equal(prof.H, plain.H)
    assert torch.equal(prof.rel_errors, plain.rel_errors)
    assert set(prof.extras["phase_times"]) == set(expected_phases("serial"))


@pytest.mark.cuda
def test_generators_draw_on_the_card(cuda_device):
    from repro_torch.data import pipeline
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    V = pipeline.video_like_matrix(gen, 3_000, 2_000, rank=8, motion=0.05)
    bg = pipeline.lowrank_matrix(
        torch.Generator(device=cuda_device).manual_seed(0), 3_000, 2_000, 8)
    assert V.is_cuda and abs(float((V != bg).float().mean()) - 0.05) < 1e-3
    D = pipeline.erdos_renyi_matrix(
        torch.Generator(device=cuda_device).manual_seed(1), 500, 400, 0.1)
    S = pipeline.erdos_renyi_bcoo(
        torch.Generator(device=cuda_device).manual_seed(1), 500, 400, 0.1)
    assert torch.equal(S.to_dense(), D) and int((D != 0).sum()) == 20_000
    X = pipeline.bow_like_matrix(
        torch.Generator(device=cuda_device).manual_seed(2), 1_000, 300)
    assert X.is_cuda and torch.equal(X, X.round()) and bool((X >= 0).all())
    a = pipeline.stream_batch(3, 4, rows=8, n=50, k=4, drift=0.1)
    assert a.is_cuda and torch.equal(a, pipeline.stream_batch(
        3, 4, rows=8, n=50, k=4, drift=0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["mu", "hals"])
@pytest.mark.parametrize("shard", ["batch", "features"])
def test_mesh_foldin_runs_the_kernels_on_every_shard(cuda_device, algo,
                                                     shard):
    """Four shards on one card: ``ts_matmul`` once per shard, the LUC
    kernel once per shard per sweep; the codes agree with one device."""
    from repro_torch.serve.mesh import serve_mesh
    w, h, r = _inputs(22, (4_000, 16), (16, 3_000), (64, 16))
    art = FactorArtifact.from_factors(w, h, algo=algo)
    rows = torch.from_numpy(r @ h).to(cuda_device)
    single = FoldInProjector(art, max_batch=64, iters=20)
    want = single.project(rows)
    mesh = serve_mesh(4, devices=[cuda_device] * 4)
    proj = FoldInProjector(art, max_batch=64, iters=20, mesh=mesh,
                           shard=shard)
    ops.reset_launches()
    got = proj.project(rows)
    torch.cuda.synchronize()
    luc = "mu_update" if algo == "mu" else "hals_sweep"
    assert ops.LAUNCHES["ts_matmul"] == 4
    assert ops.LAUNCHES[luc] == 4 * 20
    _assert_scaled(got.cpu(), want.cpu(), 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["tree", "gather"])
def test_mesh_topk_and_autotuned_chunk_on_the_card(cuda_device, merge,
                                                   tmp_path, monkeypatch):
    from repro_torch.kernels import autotune
    from repro_torch.serve.mesh import serve_mesh
    from repro_torch.serve.topk import topk_rows
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "tune.json"))
    autotune.clear()
    w, q = _inputs(23, (40_000, 16), (8, 16))
    W = torch.from_numpy(w).to(cuda_device)
    want = topk_rows(W, q, k=10, metric="dot")
    got = topk_rows(W, q, k=10, metric="dot", chunk=None,
                    mesh=serve_mesh(4, devices=[cuda_device] * 4),
                    merge=merge)
    assert torch.equal(got[1], want[1])
    entry = next(iter(autotune._load().values()))
    assert entry["chosen_us"] <= entry["times_us"][str((4096,))]
    assert entry["chosen_us"] > 0
    autotune.clear()


# The mixed instantiation (bf16 A · fp32 B) of both products: the shapes
# above, every axis ragged and A's rows off the 16-byte grid, and an A past
# 2³¹ elements (offsets that need 64 bits).
MIXED_SHAPES = SHAPES + [(4_099, 1_001, 1), (20_001, 1_003, 128),
                         (1_003, 301, 64)]


def _mixed_pair(product, A, B):
    """(mixed launch, plain version, float64 product) of ``product``."""
    got = getattr(ops, product)(A, B)
    plain = getattr(ref, product)(A, B)
    A64 = A.double() if product == "ts_matmul" else A.double().T
    return got, plain, A64 @ B.double()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", MIXED_SHAPES)
@pytest.mark.parametrize("product", ["ts_matmul", "ts_matmul_t"])
def test_mixed_products_match_plain_and_float64(cuda_device, product, m, n,
                                                k):
    a, b = _inputs(31, (m, n), (n, k) if product == "ts_matmul" else (m, k))
    A = torch.from_numpy(a).to(cuda_device, torch.bfloat16)
    B = torch.from_numpy(b).to(cuda_device)
    for A_, B_ in ((A, B), (_off_grid(A), _off_grid(B))):
        ops.reset_launches()
        got, plain, f64 = _mixed_pair(product, A_, B_)
        torch.cuda.synchronize()
        assert ops.LAUNCHES == _launches(**{f"{product}_mixed": 1})
        assert got.dtype == torch.float32 and A_.dtype == torch.bfloat16
        _assert_scaled(got.cpu(), plain.cpu(), TOL["f32"])
        _assert_scaled(got.cpu(), f64.cpu(), TOL["f32"])
        # a bf16 value's small tf32 part is 0: the mixed kernel's sums are
        # the fp32 kernel's on A widened to fp32, bit for bit
        assert torch.equal(got, getattr(ops, product)(A_.float(), B_))
        assert torch.equal(got, getattr(ops, product)(A_, B_))


@pytest.mark.cuda
@pytest.mark.parametrize("product", ["ts_matmul", "ts_matmul_t"])
def test_mixed_products_past_2_31_offsets(cuda_device, product):
    m, n, k = 163_840, 13_824, 50                 # 2.26e9 elements of A
    A, B = _device_inputs(cuda_device, 32, (m, n),
                          (n, k) if product == "ts_matmul" else (m, k))
    A16 = A.to(torch.bfloat16)
    del A
    got = getattr(ops, product)(A16, B)
    torch.cuda.synchronize()
    rows = 16_384
    if product == "ts_matmul":
        for r0 in range(0, m, rows):
            blk = A16[r0:r0 + rows]
            _assert_scaled(got[r0:r0 + rows].cpu(),
                           (blk.double() @ B.double()).cpu(), TOL["f32"])
    else:
        want = torch.zeros((n, k), dtype=torch.float64, device=cuda_device)
        for r0 in range(0, m, rows):
            want += A16[r0:r0 + rows].double().T @ B[r0:r0 + rows].double()
        _assert_scaled(got.cpu(), want.cpu(), TOL["f32"])
    assert torch.equal(got, getattr(ops, product)(A16.float(), B))


@pytest.mark.cuda
def test_bf16_bpp_fit_on_the_card_runs_the_mixed_kernel(cuda_device):
    rng = np.random.default_rng(33)
    m, n, k = 96, 64, 6
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + 0.5 * rng.uniform(size=(m, n))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    A, W0, H0 = (torch.from_numpy(x).to(torch.bfloat16) for x in (A, W0, H0))
    ops.reset_launches()
    res = NMFSolver(k, algo="bpp", max_iters=3).fit(
        A.to(cuda_device), W0=W0, H0=H0)
    # the H-step's AᵀW meets BPP's fp32 W: the mixed instantiation
    assert ops.LAUNCHES == _launches(gram=9, ts_matmul=3, ts_matmul_t_mixed=3)
    assert res.W.dtype == torch.bfloat16
    cpu = NMFSolver(k, algo="bpp", device="cpu", max_iters=3).fit(
        A, W0=W0, H0=H0)
    np.testing.assert_allclose(res.rel_errors.numpy(),
                               cpu.rel_errors.numpy(), rtol=1e-3)
    _assert_scaled(res.W.float().cpu(), cpu.W.float(), 1e-2)
    _assert_scaled(res.H.float().cpu(), cpu.H.float(), 1e-2)


@pytest.mark.cuda
def test_bf16_batch_on_fp32_factors_runs_the_mixed_kernel(cuda_device):
    rng = np.random.default_rng(34)
    W = rng.uniform(size=(200, 6)).astype(np.float32)
    H = rng.uniform(size=(6, 300)).astype(np.float32)
    rows = torch.from_numpy((rng.uniform(size=(7, 6)) @ H).astype(np.float32))
    art = FactorArtifact.from_factors(W, H, algo="mu", device=cuda_device)
    proj = FoldInProjector(art, iters=20)
    ops.reset_launches()
    got = proj.project(rows.to(cuda_device, torch.bfloat16))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["ts_matmul_mixed"] == 1
    assert ops.LAUNCHES["ts_matmul"] == 0
    # the same batch widened to fp32 gives the same codes
    assert torch.equal(got, proj.project(
        rows.to(torch.bfloat16).float().to(cuda_device)))


@pytest.mark.cuda
def test_concurrent_launches_of_one_kernel_on_two_plans(cuda_device):
    """hals_sweep's entry point sets the kernel's shared-memory limit for
    the call's plan, then launches: two threads folding batches of other
    sizes (a served request beside an ingest) launch it on two plans at
    once, and every launch must go through (and count)."""
    import threading
    gen = torch.Generator(device=cuda_device).manual_seed(35)
    G = torch.rand((50, 50), generator=gen, device=cuda_device)
    G = G @ G.T + 50 * torch.eye(50, device=cuda_device)
    cases = [(torch.rand((r, 50), generator=gen, device=cuda_device),
              torch.rand((r, 50), generator=gen, device=cuda_device))
             for r in (4_096, 3)]
    alone = [ops.hals_sweep(X, G, R) for X, R in cases]
    errors = []

    def body(i):
        try:
            X, R = cases[i]
            for _ in range(200):
                got = ops.hals_sweep(X, G, R)
            torch.cuda.synchronize()
            assert torch.equal(got, alone[i])      # each plan's own bits
        except Exception as e:                    # reported after join
            errors.append(e)

    ops.reset_launches()
    threads = [threading.Thread(target=body, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert ops.LAUNCHES["hals_sweep"] == 400
