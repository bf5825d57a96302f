"""Mixed-operand dense products: ``ts_matmul`` / ``ts_matmul_t`` with a bf16
A beside an fp32 B (and the reverse), and the fits that reach them — a
bf16 A with ``algo="bpp"`` on ``backend="cuda"``, whose BPP solve hands the
H-step an fp32 W — held against the JAX package's ``pallas`` backend.

On the CPU the wrappers run their plain versions; the mixed CUDA
instantiation is held against them on the card by test_torch_cuda.py and
chip_smoke.py (phase 23).  The grid runs are spawned on gloo ranks; this
module imports no JAX at its top, so the ranks never import it.

Tolerances: the products of a bf16 A are exact in fp32, so a mixed product
is held at the fp32 kernels' scaled 1e-5.  A bf16 fit rounds W and H to
bf16 after every step, so a different fp32 summation order flips single
bf16 roundings (2⁻⁸ ≈ 3.9e-3 relative): the factors are held at a scaled
1e-2 and the rel errors at rtol 1e-3 (the largest distance seen over the
cases here: 2.8e-3 scaled, 3.7e-4 relative).
"""

import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.engine import NMFSolver
from repro_torch.core.faun import make_faun_grid
from repro_torch.kernels import ops
from repro_torch.util import dist as rdist

torch.set_num_threads(1)

# The shapes of tests/test_kernels.py.
SHAPES = [(64, 48, 8), (96, 128, 16), (100, 70, 10), (128, 64, 50),
          (32, 256, 4)]
M, N, K = 96, 64, 6
ITERS = 3
FACTOR_TOL, REL_RTOL = 1e-2, 1e-3
# (tag, schedule, grid (pr, pc) or naive p, backend)
GRID_CASES = [("faun_2x2_cuda", "faun", (2, 2), "cuda"),
              ("faun_1x4_cuda", "faun", (1, 4), "cuda"),
              ("naive_4_cuda", "naive", 4, "cuda"),
              ("gspmd_2x2_dense", "gspmd", (2, 2), "dense")]


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(size=s).astype(np.float32) for s in shapes]


def _problem(seed=0):
    """Low rank plus noise (tests/test_torch_engine.py's problem)."""
    rng = np.random.default_rng(seed)
    A = (rng.uniform(size=(M, K)) @ rng.uniform(size=(K, N))
         + 0.5 * rng.uniform(size=(M, N))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(M, K)).astype(np.float32)
    H0 = rng.uniform(size=(K, N)).astype(np.float32)
    return A, W0, H0


def _bf16(*arrays):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


def _assert_scaled(got, want, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


# ---------------------------------------------------------------------------
# The products against the JAX package's wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("a_dt,b_dt", [("bf16", "f32"), ("f32", "bf16")])
@pytest.mark.parametrize("product", ["ts_matmul", "ts_matmul_t"])
def test_mixed_product_matches_jax(product, a_dt, b_dt, m, n, k):
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    a, b = _inputs(7, (m, n), (n, k) if product == "ts_matmul" else (m, k))
    dts = {"f32": (torch.float32, jnp.float32),
           "bf16": (torch.bfloat16, jnp.bfloat16)}
    A, B = (torch.from_numpy(a).to(dts[a_dt][0]),
            torch.from_numpy(b).to(dts[b_dt][0]))
    Aj, Bj = (jnp.asarray(a).astype(dts[a_dt][1]),
              jnp.asarray(b).astype(dts[b_dt][1]))
    got = getattr(ops, product)(A, B)
    assert got.dtype == torch.float32 and A.dtype == dts[a_dt][0]
    _assert_scaled(got.numpy(), getattr(jops, product)(Aj, Bj), 1e-5)
    _assert_scaled(got.numpy(), getattr(jref, product)(Aj, Bj), 1e-5)
    # the widened operands give the same product: mixed is no new arithmetic
    same = getattr(ops, product)(A.float(), B.float())
    torch.testing.assert_close(got, same, rtol=0, atol=0)


def test_mixed_products_keep_other_refusals():
    A, B = _bf16(*_inputs(8, (16, 12), (12, 4)))
    with pytest.raises(TypeError):                   # fp16 is not taken
        ops.ts_matmul(A, B.half())
    with pytest.raises(ValueError):                  # strided B
        ops.ts_matmul(A, torch.zeros(4, 12).T)
    with pytest.raises(ValueError):                  # rows do not match
        ops.ts_matmul_t(A, B.float())
    with pytest.raises(ValueError):                  # SpMMs keep one dtype
        idx = torch.arange(4, dtype=torch.int32)
        ops.spmm(torch.ones(4, dtype=torch.bfloat16), idx, idx, B.float(), 16)


# ---------------------------------------------------------------------------
# The bf16 bpp fit on backend="cuda" (fault F2)
# ---------------------------------------------------------------------------

@functools.cache
def _jax_pallas_bf16(algo="bpp"):
    import jax.numpy as jnp
    from repro.core.engine import NMFSolver as JaxSolver
    A, W0, H0 = _problem()
    res = JaxSolver(K, algo=algo, backend="pallas", max_iters=ITERS).fit(
        jnp.asarray(A).astype(jnp.bfloat16),
        W0=jnp.asarray(W0).astype(jnp.bfloat16),
        H0=jnp.asarray(H0).astype(jnp.bfloat16))
    assert res.W.dtype == jnp.bfloat16
    return {"W": np.asarray(res.W.astype(jnp.float32)),
            "H": np.asarray(res.H.astype(jnp.float32)),
            "rels": np.asarray(res.rel_errors)}


def _assert_like_jax(W, H, rels):
    want = _jax_pallas_bf16()
    np.testing.assert_allclose(rels, want["rels"], rtol=REL_RTOL)
    _assert_scaled(W, want["W"], FACTOR_TOL)
    _assert_scaled(H, want["H"], FACTOR_TOL)


def test_bf16_bpp_fit_on_cuda_backend_matches_jax_pallas():
    A, W0, H0 = _bf16(*_problem())
    res = NMFSolver(K, algo="bpp", backend="cuda", device="cpu",
                    max_iters=ITERS).fit(A, W0=W0, H0=H0)
    assert res.W.dtype == res.H.dtype == torch.bfloat16
    _assert_like_jax(res.W.float().numpy(), res.H.float().numpy(),
                     res.rel_errors.numpy())


@pytest.mark.parametrize("algo", ["mu", "hals", "bpp", "amu", "ahals"])
def test_bf16_carry_fits_on_cuda_equal_dense(algo):
    """Every rule with a bf16 A and carry runs on ``cuda`` (no product
    refuses its operands) and gives the dense backend's bits on the CPU."""
    A, W0, H0 = _bf16(*_problem(1))
    got, want = (NMFSolver(K, algo=algo, backend=b, device="cpu",
                           max_iters=ITERS).fit(A, W0=W0, H0=H0)
                 for b in ("cuda", "dense"))
    for x, y in ((got.W, want.W), (got.H, want.H),
                 (got.rel_errors, want.rel_errors)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _grid_rank(out):
    A, W0, H0 = _bf16(*_problem())
    for tag, schedule, shape, backend in GRID_CASES:
        kw = dict(algo="bpp", schedule=schedule, backend=backend,
                  device="cpu", max_iters=ITERS)
        if schedule == "naive":
            if shape != dist.get_world_size():
                continue
        else:
            kw["grid"] = make_faun_grid(*shape)
        res = NMFSolver(K, **kw).fit(A, W0=W0, H0=H0)
        if dist.get_rank() == 0:
            np.savez(os.path.join(out, f"{tag}.npz"), W=res.W.float().numpy(),
                     H=res.H.float().numpy(), rels=res.rel_errors.numpy(),
                     dtype=str(res.W.dtype))


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mixed"))
    rdist.spawn(_grid_rank, 4, out, backend="gloo", device="cpu")
    return out


@pytest.mark.parametrize("case", GRID_CASES, ids=lambda c: c[0])
def test_bf16_bpp_on_grids_matches_jax_pallas(grid_runs, case):
    with np.load(os.path.join(grid_runs, f"{case[0]}.npz")) as z:
        assert str(z["dtype"]) == "torch.bfloat16"
        _assert_like_jax(z["W"], z["H"], z["rels"])
