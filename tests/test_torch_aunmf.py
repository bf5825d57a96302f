"""Fault F4: the port's serial entry point ``repro_torch.core.aunmf.fit``
against the JAX package's ``aunmf.fit`` (mu, hals, bpp) on
tests/test_nmf_serial.py's problem, both from the same W0/H0, and the
weight compression of examples/weight_compress.py (|wi_up| of smollm
reduced, bpp at k = 4 and 8) from JAX params carried across.

Factors are held at a scaled 1e-4 (max |Δ| / max |ref|).  The rel errors
come from the trace trick's fp32 byproducts, whose cancellation leaves an
absolute error of about 1e-6 / (2·rel) (≈ 4e-5 at rel = 0.013, where bpp
ends on this problem; the reference's own dense and pallas backends part
as much): they are held at 1e-4 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.core import aunmf as jaunmf
from repro.data.pipeline import lowrank_matrix
from repro.models import lm as jlm
from repro_torch.configs import base as cb
from repro_torch.core import aunmf
from repro_torch.util.convert import lm_params_from_numpy

torch.set_num_threads(1)

KEY = jax.random.PRNGKey(0)
TOL = 1e-4
REL_ATOL = 1e-4


def scaled(got, want) -> float:
    got = np.asarray(got.detach() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-9))


def _init(m, n, k, algo, seed=0):
    """W0/H0 as the engines draw them: H uniform on [0, 1); W positive for
    MU, zeros for the re-solving rules."""
    rng = np.random.default_rng(seed)
    H0 = rng.random((k, n), dtype=np.float32)
    W0 = (rng.uniform(0.1, 1.0, (m, k)).astype(np.float32) if algo == "mu"
          else np.zeros((m, k), np.float32))
    return W0, H0


def _both(A, k, algo, iters, **kw):
    W0, H0 = _init(*A.shape, k, algo)
    ref = jaunmf.fit(jnp.asarray(A), k, algo=algo, iters=iters,
                     W0=jnp.asarray(W0), H0=jnp.asarray(H0))
    ours = aunmf.fit(A, k, algo=algo, iters=iters, W0=W0, H0=H0,
                     device="cpu", **kw)
    return ref, ours


@pytest.mark.parametrize("backend", [None, "dense"])
@pytest.mark.parametrize("algo", ["mu", "hals", "bpp"])
def test_fit_matches_jax(algo, backend):
    A = np.array(lowrank_matrix(KEY, 120, 90, 8, noise=0.01))
    ref, ours = _both(A, 8, algo, 20, backend=backend)
    assert ours.algo == algo and ours.iters == 20
    assert ours.W.shape == (120, 8) and ours.H.shape == (8, 90)
    assert float(ours.W.min()) >= 0 and float(ours.H.min()) >= 0
    assert scaled(ours.W, ref.W) < TOL
    assert scaled(ours.H, ref.H) < TOL
    np.testing.assert_allclose(ours.rel_errors.numpy(),
                               np.asarray(ref.rel_errors), rtol=0,
                               atol=REL_ATOL)


def test_fit_backend_defaults():
    """Dense input runs the CUDA backend (its plain versions on the CPU),
    sparse input the sparse one, as ``faun.fit`` chooses."""
    A = np.array(lowrank_matrix(KEY, 40, 30, 3, noise=0.5))
    seeded = aunmf.fit(A, 3, algo="mu", iters=3, seed=5, device="cpu")
    again = aunmf.fit(torch.as_tensor(A), 3, algo="mu", iters=3, seed=5,
                      device="cpu", backend="cuda")
    assert torch.equal(seeded.W, again.W)
    sparse = aunmf.fit(torch.as_tensor(A).to_sparse_coo(), 3, algo="mu",
                       iters=3, seed=5, device="cpu")
    assert scaled(sparse.W, seeded.W) < TOL


@pytest.mark.parametrize("k", [4, 8])
def test_weight_compression_matches_jax(k):
    """examples/weight_compress.py at smollm reduced: |wi_up| of every
    layer, stacked (3 × 72 rows, 192 columns), bpp for 30 iterations."""
    jcfg = jcb.get_reduced_config("smollm_135m")
    params = jlm.init_params(jcfg, KEY)
    model = lm_params_from_numpy(cb.get_reduced_config("smollm_135m"),
                                 jax.tree.map(np.asarray, params),
                                 device="cpu")
    wi = params["dec"]["groups"]["p0"]["ffn"]["mlp"]["wi_up"]
    L, D, F = wi.shape
    A_ref = np.asarray(jnp.abs(wi.reshape(L * D, F).astype(jnp.float32)))
    A = torch.stack([blk.ffn.mlp.wi_up.detach()
                     for blk in model.dec.layers()]).reshape(L * D, F).abs()
    np.testing.assert_array_equal(A.numpy(), A_ref)
    ref, ours = _both(A.numpy(), k, "bpp", 30)
    assert scaled(ours.W, ref.W) < TOL
    assert scaled(ours.H, ref.H) < TOL
    np.testing.assert_allclose(ours.rel_errors.numpy(),
                               np.asarray(ref.rel_errors), rtol=0,
                               atol=REL_ATOL)
