"""The port's CUDA kernels and its engine on the card, held against their
plain PyTorch versions (the CPU path, itself held against the JAX package
by the other test_torch_* files).

Every test here needs an NVIDIA GPU and skips without one.  This file
imports neither jax nor the JAX package, so it runs on a machine that has
only PyTorch; from the repo root (``--noconftest``: tests/conftest.py
imports jax):

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""

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
LUC_PER_ITER = {"mu": {"mu_update": 2}, "hals": {"hals_sweep": 1},
                "bpp": {}, "amu": {"mu_update": 4}, "ahals": {"hals_sweep": 2}}


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
# = 1 and k = 128 (the largest the kernels take), and a 65,536-row slice
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
    X = torch.rand(64, 129, device=cuda_device)
    G = torch.rand(129, 129, device=cuda_device)
    with pytest.raises(ValueError, match="k <= 128"):
        ops.mu_update(X, G, X)
    X = torch.rand(64, 8, device=cuda_device)
    with pytest.raises(TypeError):
        ops.hals_sweep(X, torch.rand(8, 8, device=cuda_device).bfloat16(), X)
    with pytest.raises(ValueError):
        ops.hals_sweep(X, torch.rand(8, 8), X)          # G on the CPU


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
