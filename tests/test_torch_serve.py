"""The port's single-device serving chain against the JAX package's:
factor artifacts on disk in both directions (checksums, corruption,
lineage, the transposed view), ``FoldInProjector`` for every algorithm on
dense and sparse rows (bucket padding, validation), and ``topk_rows`` /
``TopK`` — on inputs made with numpy from a seed.

On the CPU the kernel wrappers run their plain versions; the fold-in's
kernels on the card are checked by test_torch_cuda.py and chip_smoke.py.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

from repro.serve.artifact import FactorArtifact as JaxArtifact
from repro.serve.foldin import FoldInProjector as JaxProjector
from repro.serve.foldin import default_buckets as jax_buckets
from repro.serve.topk import TopK as JaxTopK
from repro.serve.topk import topk_rows as jax_topk_rows
from repro_torch.backends import SparseOps
from repro_torch.checkpoint.checkpoint import (CheckpointCorrupt,
                                               read_payload, write_payload)
from repro_torch.core import blocksparse
from repro_torch.core.engine import NMFSolver
from repro_torch.serve.artifact import FactorArtifact
from repro_torch.serve.foldin import FoldInProjector, default_buckets
from repro_torch.serve.topk import TopK, topk_rows

torch.set_num_threads(1)

M, N, K = 96, 64, 6
ALGOS = ["bpp", "mu", "hals", "amu", "ahals"]


def _assert_scaled(got, want, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


def _factors(seed=0):
    """Nonnegative W (M, K), H (K, N) and request rows near their span
    (rank K plus noise, so every rule's fold-in is well posed)."""
    rng = np.random.default_rng(seed)
    W = rng.uniform(size=(M, K)).astype(np.float32)
    H = rng.uniform(size=(K, N)).astype(np.float32)
    rows = (rng.uniform(size=(40, K)) @ H
            + 0.1 * rng.uniform(size=(40, N))).astype(np.float32)
    return W, H, rows


def _sparse_rows(seed, b, density=0.2):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(b, N)) * (rng.uniform(size=(b, N)) < density)
            ).astype(np.float32)


def _art(**meta):
    W, H, _ = _factors()
    return FactorArtifact.from_factors(W, H, algo="bpp", device="cpu", **meta)


# ------------------------------------------------------------- artifact --

def test_artifact_from_jax_loads_in_the_port(tmp_path):
    W, H, _ = _factors()
    jart = JaxArtifact.from_factors(jnp.asarray(W), jnp.asarray(H),
                                    algo="hals", corpus="unit-test")
    path = jart.save(str(tmp_path / "jax_art"))
    art = FactorArtifact.load(path, device="cpu")
    np.testing.assert_array_equal(art.W.numpy(), W)
    np.testing.assert_array_equal(art.H.numpy(), H)
    np.testing.assert_array_equal(art.gram.numpy(), np.asarray(jart.gram))
    assert art.algo == "hals" and art.meta == jart.meta
    assert art.k == K and art.shape == (M, N) and art.device.type == "cpu"


def test_artifact_from_the_port_loads_in_jax(tmp_path):
    art = _art(corpus="unit-test")
    path = art.save(str(tmp_path / "art"))
    jart = JaxArtifact.load(path)
    np.testing.assert_array_equal(np.asarray(jart.W), art.W.numpy())
    np.testing.assert_array_equal(np.asarray(jart.H), art.H.numpy())
    np.testing.assert_array_equal(np.asarray(jart.gram), art.gram.numpy())
    assert jart.algo == "bpp" and jart.meta == {"corpus": "unit-test"}
    # the gram is HHᵀ, and meta.json carries the reference's keys
    np.testing.assert_allclose(art.gram.numpy(), art.H.numpy()
                               @ art.H.numpy().T, rtol=1e-5)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    assert set(meta) == {"format", "version", "algo", "k", "shape", "meta",
                         "checksums"}


def test_save_artifact_keeps_training_provenance(tmp_path):
    A, W0, H0 = (np.random.default_rng(1).uniform(size=s).astype(np.float32)
                 for s in ((M, N), (M, K), (K, N)))
    res = NMFSolver(K, algo="mu", device="cpu", max_iters=3).fit(
        A, W0=W0, H0=H0)
    path = res.save_artifact(str(tmp_path / "art"), corpus="x")
    art = FactorArtifact.load(path, device="cpu")
    torch.testing.assert_close(art.W, res.W, rtol=0, atol=0)
    assert art.algo == "mu" and art.meta["iters"] == 3
    assert art.meta["rel_error"] == pytest.approx(float(res.rel_errors[-1]))
    assert art.meta["backend"] == "cuda" and art.meta["corpus"] == "x"
    jart = JaxArtifact.load(path)
    assert jart.meta == art.meta


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_flipped_byte_raises_checkpoint_corrupt(tmp_path, writer):
    W, H, _ = _factors()
    if writer == "port":
        path = _art().save(str(tmp_path / "art"))
    else:
        path = JaxArtifact.from_factors(jnp.asarray(W), jnp.asarray(H)).save(
            str(tmp_path / "art"))
    npz = os.path.join(path, "arrays.npz")
    data = bytearray(open(npz, "rb").read())
    with np.load(npz) as z:                 # a byte inside W's data
        arrays = {k: z[k] for k in z.files}
    data[bytes(data).index(arrays["W"].tobytes()[:16]) + 8] ^= 0xFF
    with open(npz, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(CheckpointCorrupt):
        FactorArtifact.load(path, device="cpu")
    # an npz that opens but whose W no longer matches meta.json's checksum
    arrays["W"] = arrays["W"] + 1.0
    np.savez(npz, **arrays)
    with pytest.raises(CheckpointCorrupt, match="checksum"):
        FactorArtifact.load(path, device="cpu")
    got, _ = read_payload(path, verify=False)        # still readable raw
    assert got["W"].shape == (M, K)


def test_payload_checksums_match_the_reference(tmp_path):
    from repro.checkpoint.checkpoint import _checksum as jax_checksum
    from repro.checkpoint.checkpoint import read_payload as jax_read
    from repro_torch.checkpoint.checkpoint import _checksum
    arrays = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
              "b": np.ones(5, np.int32)}
    for a in arrays.values():
        assert _checksum(a) == jax_checksum(a)
    path = write_payload(str(tmp_path / "p"), arrays, {"step": 3})
    got, meta = jax_read(path)
    assert meta["step"] == 3 and set(got) == {"a", "b"}
    write_payload(path, {"a": arrays["a"] + 1}, {"step": 4})  # overwrite
    got, meta = read_payload(path)
    assert meta["step"] == 4 and set(got) == {"a"}
    with pytest.raises(CheckpointCorrupt):
        read_payload(str(tmp_path / "missing"))


def test_artifact_rejects_foreign_payload_and_mesh(tmp_path):
    p = write_payload(str(tmp_path / "ckpt"), {"x": np.zeros(3)}, {"step": 0})
    with pytest.raises(ValueError, match="format"):
        FactorArtifact.load(p, device="cpu")
    art = _art()
    with pytest.raises(TypeError, match="serve mesh"):
        art.shard(object())
    assert art.valid_rows is None
    with pytest.raises(TypeError, match="serve mesh"):
        FactorArtifact.load(art.save(str(tmp_path / "art")), mesh=object())


def test_artifact_transposed_and_lineage_match_jax():
    W, H, _ = _factors()
    art = _art()
    jart = JaxArtifact.from_factors(jnp.asarray(W), jnp.asarray(H))
    t, jt = art.transposed(), jart.transposed()
    np.testing.assert_array_equal(t.W.numpy(), np.asarray(jt.W))
    np.testing.assert_array_equal(t.H.numpy(), np.asarray(jt.H))
    _assert_scaled(t.gram.numpy(), jt.gram, 1e-6)
    assert t.meta["transposed"] and t.shape == (N, M)
    child = art.evolve(W=W[:50], rows_absorbed=7, refresh="blocks")
    jchild = jart.evolve(W=jnp.asarray(W[:50]), rows_absorbed=7,
                         refresh="blocks")
    assert child.meta == jchild.meta and child.gram is art.gram
    assert (child.version, child.parent_version, child.rows_absorbed) == \
        (1, 0, 7)
    grand = child.evolve(H=H * 2)
    _assert_scaled(grand.gram.numpy(), jchild.evolve(H=jnp.asarray(H) * 2)
                   .gram, 1e-6)
    with pytest.raises(ValueError, match="feature space"):
        art.evolve(H=H[:, :10])
    with pytest.raises(ValueError, match="compose"):
        FactorArtifact.from_factors(W, H[:3], device="cpu")
    state = art.projection_state()
    assert state.algo == "bpp"
    torch.testing.assert_close(state.diag, torch.diagonal(art.gram))


# -------------------------------------------------------------- fold-in --

def _jax_projector(algo, **kw):
    W, H, _ = _factors()
    return JaxProjector(JaxArtifact.from_factors(jnp.asarray(W),
                                                 jnp.asarray(H)),
                        algo=algo, **kw)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("algo", ALGOS)
def test_foldin_matches_jax(algo, sparse):
    _, _, rows = _factors()
    if sparse:
        rows = _sparse_rows(2, 13)
    proj = FoldInProjector(_art(), algo=algo, max_batch=32, device="cpu")
    jproj = _jax_projector(algo, max_batch=32)
    if sparse:
        got = proj.project(torch.from_numpy(rows).to_sparse_coo())
        want = jproj.project(jsparse.BCOO.fromdense(jnp.asarray(rows)))
    else:
        got = proj.project(rows[:13])
        want = jproj.project(jnp.asarray(rows[:13]))
    assert got.shape == (13, K) and got.dtype == torch.float32
    assert (got >= 0).all()
    _assert_scaled(got.numpy(), want, 1e-4)


@pytest.mark.parametrize("algo", ALGOS)
def test_foldin_sparse_forms_match_the_dense_path(algo):
    rows = _sparse_rows(3, 9)
    proj = FoldInProjector(_art(), algo=algo, max_batch=16, device="cpu")
    dense = proj.project(rows)
    for form in (torch.from_numpy(rows).to_sparse_coo(),
                 torch.from_numpy(rows).to_sparse_csr(),
                 blocksparse.blockify(rows, 1, 1)):
        _assert_scaled(proj.project(form).numpy(), dense.numpy(), 1e-5)


@pytest.mark.parametrize("algo", ALGOS)
def test_foldin_bucket_padding_is_invisible(algo):
    """A padded batch returns what the same rows get in a full bucket: zero
    padding rows fold to zero and are sliced off."""
    _, _, rows = _factors()
    proj = FoldInProjector(_art(), algo=algo, max_batch=16, device="cpu")
    full = proj.project(rows[:16])
    part = proj.project(rows[:5])                     # padded 5 -> 8
    _assert_scaled(part.numpy(), full.numpy()[:5], 1e-5)
    G, Ht = proj.G, proj.Ht
    padded = torch.cat([torch.from_numpy(rows[:5]), torch.zeros(3, N)]) @ Ht
    assert not proj._fold(G, padded)[5:].any()


def test_foldin_transposed_folds_columns():
    """transposed() folds new COLUMNS of A (frames, documents): against the
    reference's transposed projector."""
    W, H, _ = _factors()
    cols = (np.random.default_rng(4).uniform(size=(6, K)) @ W.T
            ).astype(np.float32)                     # (6, M)
    got = FoldInProjector(_art().transposed(), algo="hals",
                          device="cpu").project(cols)
    want = JaxProjector(JaxArtifact.from_factors(
        jnp.asarray(W), jnp.asarray(H)).transposed(), algo="hals").project(
        jnp.asarray(cols))
    _assert_scaled(got.numpy(), want, 1e-4)


def test_foldin_validation():
    W, H, rows = _factors()
    proj = FoldInProjector(torch.from_numpy(H), algo="bpp", device="cpu")
    _assert_scaled(proj.project(rows[:4]).numpy(),
                   _jax_projector("bpp").project(jnp.asarray(rows[:4])),
                   1e-4)
    with pytest.raises(ValueError, match="features"):
        proj.project(np.ones((2, N + 1), np.float32))
    with pytest.raises(ValueError, match="max_batch"):
        FoldInProjector(H, max_batch=8, device="cpu").project(
            np.ones((9, N), np.float32))
    with pytest.raises(ValueError, match="k, n"):
        FoldInProjector(np.ones(3, np.float32), device="cpu")
    with pytest.raises(ValueError, match="sort_rows"):
        FoldInProjector(H, backend=SparseOps(spmm_impl="sorted"),
                        device="cpu")
    with pytest.raises(ValueError, match="empty"):
        proj._bucket(0)
    with pytest.raises(ValueError, match="largest bucket"):
        FoldInProjector(H, max_batch=8, buckets=(1, 4), device="cpu")
    with pytest.raises(ValueError, match="1×1"):
        proj.project(blocksparse.blockify(np.ones((4, N), np.float32), 2, 1))
    with pytest.raises(TypeError, match="serve mesh"):
        FoldInProjector(H, mesh=object())
    # without a mesh the shard axis has nothing to split (the reference's
    # behaviour): the projection is the single-device one
    feat = FoldInProjector(H, shard="features", device="cpu")
    np.testing.assert_array_equal(feat.project(rows[:4]).numpy(),
                                  proj.project(rows[:4]).numpy())
    with pytest.raises(ValueError, match="shard"):
        FoldInProjector(H, shard="rows", device="cpu")


def test_foldin_buckets_and_warmup():
    assert default_buckets(32) == jax_buckets(32) == (1, 2, 4, 8, 16, 32)
    assert default_buckets(30, 4) == jax_buckets(30, 4)
    proj = FoldInProjector(_art(), algo="mu", max_batch=8, device="cpu")
    assert proj.buckets == (1, 2, 4, 8) and proj.version == 0
    assert proj._nnz_bucket(1) == 64 and proj._nnz_bucket(65) == 128
    proj.warmup(dense=True, sparse=True, nnz_per_row=2)


# ----------------------------------------------------------------- topk --

def _topk_inputs():
    rng = np.random.RandomState(3)
    W = rng.rand(257, 5).astype(np.float32)           # odd m: ragged chunk
    X = rng.rand(4, 5).astype(np.float32)
    G = rng.rand(5, 5).astype(np.float32)
    return W, X, G @ G.T                              # PSD like HHᵀ


@pytest.mark.parametrize("metric", ["dot", "cosine"])
@pytest.mark.parametrize("use_gram", [True, False], ids=["gram", "latent"])
def test_topk_rows_matches_jax(metric, use_gram):
    W, X, G = _topk_inputs()
    g = G if use_gram else None
    vals, idx = topk_rows(torch.from_numpy(W), torch.from_numpy(X), k=7,
                          gram=None if g is None else torch.from_numpy(g),
                          metric=metric, chunk=64)
    jv, ji = jax_topk_rows(jnp.asarray(W), jnp.asarray(X), k=7,
                           gram=None if g is None else jnp.asarray(g),
                           metric=metric, chunk=64)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=1e-5)
    assert vals.dtype == torch.float32 and idx.shape == (4, 7)


def test_topk_streams_any_chunking():
    W, X, _ = _topk_inputs()
    W, X = torch.from_numpy(W[:100]), torch.from_numpy(X)
    want_v, want_i = topk_rows(W, X, k=5, chunk=100)
    for chunk in (1, 7, 32, 4096):                    # incl. chunk > m
        v, i = topk_rows(W, X, k=5, chunk=chunk)
        torch.testing.assert_close(i, want_i, rtol=0, atol=0)
        torch.testing.assert_close(v, want_v)
    v, i = topk_rows(W, X, k=5, chunk=7, valid_rows=50)
    assert (i < 50).all()


def test_topk_handle_matches_jax_and_validates():
    W, H, rows = _factors()
    art = _art()
    codes = FoldInProjector(art, device="cpu").project(rows[:8])
    vals, idx = TopK(art, metric="cosine", chunk=32).query(codes, k=3)
    jv, ji = JaxTopK(JaxArtifact.from_factors(jnp.asarray(W), jnp.asarray(H)),
                     metric="cosine", chunk=32).query(jnp.asarray(codes), k=3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jv), rtol=1e-5)
    dv, di = TopK(art, metric="dot").query(codes, k=3)
    jdv, jdi = JaxTopK(JaxArtifact.from_factors(jnp.asarray(W),
                                                jnp.asarray(H)),
                       metric="dot").query(jnp.asarray(codes), k=3)
    np.testing.assert_array_equal(di.numpy(), np.asarray(jdi))
    with pytest.raises(ValueError, match="exceeds"):
        topk_rows(art.W, codes, k=M + 1)
    with pytest.raises(ValueError, match="metric"):
        topk_rows(art.W, codes, metric="euclid")
    with pytest.raises(TypeError, match="serve mesh"):
        TopK(art, mesh=object())


def test_self_retrieval_end_to_end():
    """A training row folded back in retrieves that row of W as its own
    cosine nearest neighbour (a bpp fit, served)."""
    rng = np.random.default_rng(5)
    A = (rng.uniform(size=(M, K)) @ rng.uniform(size=(K, N))
         ).astype(np.float32)
    res = NMFSolver(K, algo="bpp", device="cpu", max_iters=30).fit(A)
    art = FactorArtifact.from_result(res)
    codes = FoldInProjector(art, device="cpu").project(A[:8])
    vals, idx = TopK(art, metric="cosine", chunk=32).query(codes, k=3)
    assert np.array_equal(idx.numpy()[:, 0], np.arange(8))
    assert (vals[:, 0] > 0.999).all()


@pytest.mark.parametrize("algo", ["mu", "hals"])
def test_foldin_at_wide_k_matches_jax(algo):
    """k = 160 (the card's wide LUC kernels): 7 rows near the span of H."""
    rng = np.random.default_rng(18)
    k = 160
    W = rng.uniform(size=(500, k)).astype(np.float32)
    H = rng.uniform(size=(k, 400)).astype(np.float32)
    rows = (rng.uniform(size=(7, k)) @ H).astype(np.float32)
    got = FoldInProjector(FactorArtifact.from_factors(W, H, device="cpu"),
                          algo=algo, iters=20, device="cpu").project(rows)
    want = JaxProjector(JaxArtifact.from_factors(jnp.asarray(W),
                                                 jnp.asarray(H)),
                        algo=algo, iters=20).project(jnp.asarray(rows))
    assert got.shape == (7, k) and (got >= 0).all()
    _assert_scaled(got.numpy(), want, 1e-4)
