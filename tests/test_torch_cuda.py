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
from repro_torch.core import blocksparse
from repro_torch.core.engine import NMFSolver
from repro_torch.kernels import ops, ref

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
    assert ops.LAUNCHES == {"gram": 1, "ts_matmul": 1, "ts_matmul_t": 1,
                            "spmm": 0, "spmm_sorted": 0}


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


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["mu", "hals", "bpp"])
def test_fit_on_the_card_matches_the_cpu_path(cuda_device, algo):
    rng = np.random.default_rng(9)
    m, n, k = 96, 64, 6
    A = (rng.uniform(size=(m, k)) @ rng.uniform(size=(k, n))
         + 0.5 * rng.uniform(size=(m, n))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(m, k)).astype(np.float32)
    H0 = rng.uniform(size=(k, n)).astype(np.float32)
    ops.reset_launches()
    res = NMFSolver(k, algo=algo, max_iters=3).fit(A, W0=W0, H0=H0)
    assert ops.LAUNCHES == {"gram": 9, "ts_matmul": 3, "ts_matmul_t": 3,
                            "spmm": 0, "spmm_sorted": 0}
    assert res.W.is_cuda and res.extras["backend"] == "cuda"
    cpu = NMFSolver(k, algo=algo, device="cpu", max_iters=3).fit(
        A, W0=W0, H0=H0)
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
    assert ops.LAUNCHES[kernel] == 6 and sum(ops.LAUNCHES.values()) == 6
    assert res.W.is_cuda and res.extras["backend"] == "sparse"
    cpu = NMFSolver(k, algo=algo, backend="sparse", device="cpu",
                    max_iters=3).fit(A, W0=W0, H0=H0)
    np.testing.assert_allclose(res.rel_errors.numpy(),
                               cpu.rel_errors.numpy(), rtol=1e-4)
    _assert_scaled(res.W.cpu(), cpu.W, 1e-4)
    _assert_scaled(res.H.cpu(), cpu.H, 1e-4)
