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
    assert ops.LAUNCHES == {"gram": 1, "ts_matmul": 1, "ts_matmul_t": 1}


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
    assert ops.LAUNCHES == {"gram": 9, "ts_matmul": 3, "ts_matmul_t": 3}
    assert res.W.is_cuda and res.extras["backend"] == "cuda"
    cpu = NMFSolver(k, algo=algo, device="cpu", max_iters=3).fit(
        A, W0=W0, H0=H0)
    np.testing.assert_allclose(res.rel_errors.numpy(),
                               cpu.rel_errors.numpy(), rtol=1e-4)
    _assert_scaled(res.W.cpu(), cpu.W, 1e-4)
    _assert_scaled(res.H.cpu(), cpu.H, 1e-4)
