"""The port's data generators (``repro_torch.data.pipeline``) against the JAX
package's.  torch's generators do not reproduce ``jax.random``'s streams,
so the two packages are held to the same statistics at the same sizes:
the Erdős–Rényi density, the video-like motion share, the bag-of-words
counts' integrality, Zipf-like rank-frequency slope and document lengths;
and the port alone to its exact contracts (dense and sparse Erdős–Rényi
agree entry for entry, a stream batch is a pure function of (seed, step)
with its truth shared by every step and its drift linear in the step).
"""

import math

import jax
import numpy as np
import pytest
import torch

from repro.data import pipeline as jp
from repro_torch.data import pipeline as tp

CPU = torch.device("cpu")


def _gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


# ------------------------------------------------------------ Erdős–Rényi --

@pytest.mark.parametrize("m,n,density", [(96, 72, 0.25), (64, 48, 0.1),
                                         (300, 200, 0.05), (40, 30, 0.3)])
def test_erdos_renyi_dense_and_sparse_agree_entry_for_entry(m, n, density):
    dense = tp.erdos_renyi_matrix(_gen(7), m, n, density)
    sparse = tp.erdos_renyi_bcoo(_gen(7), m, n, density)
    assert dense.shape == (m, n) and sparse.shape == (m, n)
    assert torch.equal(sparse.to_dense(), dense)
    # no stored zero: the sparse form holds exactly the dense nonzeros
    assert sparse.values().numel() == int((dense != 0).sum())
    # the JAX package keeps the same contract for the same key
    key = jax.random.PRNGKey(7)
    jd = np.asarray(jp.erdos_renyi_matrix(key, m, n, density))
    jb = jp.erdos_renyi_bcoo(key, m, n, density)
    np.testing.assert_array_equal(np.asarray(jb.todense()), jd)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("m,n,density", [(96, 72, 0.25), (300, 200, 0.05),
                                         (128, 128, 0.01)])
def test_erdos_renyi_density_within_three_sigma(seed, m, n, density):
    """Both packages' densities within 3σ of the requested one, σ the
    binomial's √(d(1 − d)/(mn))."""
    sigma = math.sqrt(density * (1 - density) / (m * n))
    port = float((tp.erdos_renyi_matrix(_gen(seed), m, n, density) != 0)
                 .float().mean())
    ref = float((np.asarray(jp.erdos_renyi_matrix(
        jax.random.PRNGKey(seed), m, n, density)) != 0).mean())
    assert abs(port - density) <= 3 * sigma, (port, density, sigma)
    assert abs(ref - density) <= 3 * sigma, (ref, density, sigma)


def test_erdos_renyi_values_and_dtype():
    A = tp.erdos_renyi_matrix(_gen(3), 50, 40, 0.3, dtype=torch.bfloat16)
    assert A.dtype == torch.bfloat16
    nz = A[A != 0].float()
    assert (nz > 0).all() and (nz <= 1).all()
    assert torch.equal(A, tp.erdos_renyi_matrix(_gen(3), 50, 40, 0.3,
                                                dtype=torch.bfloat16))
    full = tp.erdos_renyi_matrix(_gen(4), 6, 5, 1.0)
    assert bool((full != 0).all())


# ------------------------------------------------------------- streaming --

def test_stream_batch_is_pure_and_shares_its_truth():
    kw = dict(rows=12, n=30, k=4, drift=0.05, noise=0.01, device="cpu")
    a = tp.stream_batch(5, 3, **kw)
    assert a.shape == (12, 30) and a.dtype == torch.float32
    assert torch.equal(a, tp.stream_batch(5, 3, **kw))       # replay
    assert not torch.equal(a, tp.stream_batch(5, 4, **kw))   # fresh step
    assert not torch.equal(a, tp.stream_batch(6, 3, **kw))   # other seed
    # noise-free, drift-free rows lie in the row space of the seed's truth
    H = tp.stream_truth(5, 30, 4, device="cpu").double().numpy()
    for step in (0, 1, 7):
        A = tp.stream_batch(5, step, rows=12, n=30, k=4,
                            device="cpu").double().numpy()
        X, *_ = np.linalg.lstsq(H.T, A.T, rcond=None)
        resid = np.linalg.norm(A - X.T @ H) / np.linalg.norm(A)
        assert resid < 1e-6, (step, resid)
        assert (X > -1e-5).all() and (X < 1 + 1e-5).all()  # uniform codes


@pytest.mark.parametrize("step", [1, 4, 9])
def test_stream_batch_drift_is_linear_in_step(step):
    """Step t draws from H + drift·t·H_alt with the step's own codes X_t:
    the drifted batch less the undrifted one is drift·t·X_t·H_alt."""
    n, k, drift = 24, 3, 0.02
    H = tp.stream_truth(2, n, k, device="cpu").double().numpy()
    H_alt = tp.stream_truth(3, n, k, device="cpu").double().numpy()
    A0 = tp.stream_batch(2, step, rows=10, n=n, k=k,
                         device="cpu").double().numpy()
    Ad = tp.stream_batch(2, step, rows=10, n=n, k=k, drift=drift,
                         device="cpu").double().numpy()
    X, *_ = np.linalg.lstsq(H.T, A0.T, rcond=None)
    np.testing.assert_allclose(Ad - A0, drift * step * X.T @ H_alt,
                               atol=2e-6 * max(1, step))


def test_stream_noise_statistics_match_the_reference():
    """Uniform measurement noise of the same size in both packages."""
    kw = dict(rows=64, n=40, k=3)
    port = (tp.stream_batch(1, 2, noise=0.5, device="cpu", **kw)
            - tp.stream_batch(1, 2, device="cpu", **kw)).numpy()
    ref = (np.asarray(jp.stream_batch(1, 2, noise=0.5, **kw))
           - np.asarray(jp.stream_batch(1, 2, **kw)))
    for got in (port, ref):
        assert got.min() >= -1e-5 and got.max() <= 0.5 + 1e-5
        assert abs(got.mean() - 0.25) < 0.02


# ------------------------------------------------------------ video-like --

@pytest.mark.parametrize("motion", [0.02, 0.05, 0.2])
def test_video_like_motion_share(motion):
    """The share of entries off the low-rank background is ``motion``
    within 3σ (+ the rare object value that rounds away), in both
    packages; the background is ``lowrank_matrix`` on the same stream."""
    m, n, rank = 200, 150, 5
    sigma = math.sqrt(motion * (1 - motion) / (m * n))
    V = tp.video_like_matrix(_gen(3), m, n, rank=rank, motion=motion)
    bg = tp.lowrank_matrix(_gen(3), m, n, rank)
    share = float((V != bg).float().mean())
    key = jax.random.PRNGKey(3)
    jV = np.asarray(jp.video_like_matrix(key, m, n, rank=rank,
                                         motion=motion))
    jbg = np.asarray(jp.lowrank_matrix(key, m, n, rank))
    ref = float((jV != jbg).mean())
    for got in (share, ref):
        assert abs(got - motion) <= 3 * sigma + 1e-4, (got, motion)
    assert bool((V >= bg).all())
    assert float((V - bg).max()) < 1.0


def test_video_like_is_chunked_and_reproducible(monkeypatch):
    whole = tp.video_like_matrix(_gen(1), 37, 23, rank=4)
    assert torch.equal(whole, tp.video_like_matrix(_gen(1), 37, 23, rank=4))
    monkeypatch.setattr(tp, "_CHUNK_ELEMS", 5 * 23)      # 5-row chunks
    chunked = tp.video_like_matrix(_gen(1), 37, 23, rank=4)
    bg = tp.lowrank_matrix(_gen(1), 37, 23, 4)
    assert chunked.shape == (37, 23)
    share = float((chunked != bg).float().mean())
    assert 0.0 < share < 0.15


# ---------------------------------------------------------- bag of words --

def _zipf_slope(X, top=200):
    """Slope of log frequency against log rank over the ``top`` most
    frequent words."""
    f = np.sort(np.asarray(X, np.float64).sum(axis=1))[::-1][:top]
    r = np.arange(1, top + 1)
    ok = f > 0
    return np.polyfit(np.log(r[ok]), np.log(f[ok]), 1)[0]


def test_bow_like_counts_are_nonnegative_integers():
    X = tp.bow_like_matrix(_gen(0), 300, 80, topics=5, doc_len=50)
    assert X.shape == (300, 80) and X.dtype == torch.float32
    assert bool((X >= 0).all()) and torch.equal(X, X.round())
    assert torch.equal(X, tp.bow_like_matrix(_gen(0), 300, 80, topics=5,
                                             doc_len=50))


def test_bow_like_statistics_match_the_reference():
    """At the same sizes, over three seeds each: the Zipf-like slope within
    0.05 of the JAX generator's, the mean document length within 3σ of
    ``doc_len`` (σ = √doc_len / √docs for Poisson counts) in both, and the
    nonzero share within 5 % of the JAX generator's."""
    V, D, L = 2000, 400, 100
    port = [tp.bow_like_matrix(_gen(s), V, D, doc_len=L).numpy()
            for s in range(3)]
    ref = [np.asarray(jp.bow_like_matrix(jax.random.PRNGKey(s), V, D,
                                         doc_len=L)) for s in range(3)]
    s_port = np.mean([_zipf_slope(X) for X in port])
    s_ref = np.mean([_zipf_slope(X) for X in ref])
    assert s_port < 0 and s_ref < 0
    assert abs(s_port - s_ref) < 0.05, (s_port, s_ref)
    sigma = math.sqrt(L) / math.sqrt(D)
    for X in port + ref:
        assert abs(X.sum(axis=0).mean() - L) <= 3 * sigma
    nz_port = np.mean([(X > 0).mean() for X in port])
    nz_ref = np.mean([(X > 0).mean() for X in ref])
    assert abs(nz_port - nz_ref) < 0.05 * nz_ref, (nz_port, nz_ref)


def test_bow_like_is_chunked(monkeypatch):
    monkeypatch.setattr(tp, "_CHUNK_ELEMS", 7 * 50)      # 7 documents
    X = tp.bow_like_matrix(_gen(2), 50, 30, topics=4, doc_len=20)
    assert X.shape == (50, 30) and torch.equal(X, X.round())
    assert abs(float(X.sum(0).mean()) - 20) < 3 * math.sqrt(20 / 30)


def test_stream_generators_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tp.stream_batch(0, 0, rows=2, n=3, k=1)
