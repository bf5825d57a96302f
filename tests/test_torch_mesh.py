"""The port's mesh serving (``repro_torch.serve.mesh``) and the autotuned
top-k tile, against the JAX package.

The cases of tests/serve_distributed_checks.py run on p = 8 and p = 6
shards of the CPU (``serve_mesh(p, devices=["cpu"] * p)``, the port's
counterpart of forced host devices) and are held against the JAX package
on 8 forced host devices, which this file runs as a script in a fresh
interpreter (JAX fixes its device count at first use): batch- and
feature-sharded fold-in, the tree and gather merges (tree refused on 6),
ties resolved as ``lax.top_k`` resolves them, and the sharded artifact
round trip in both directions.  Then ``MeshServer`` end to end, with a hot
swap under live clients and a stale swap refused and logged, and the
measured chunk autotuner with its JSON cache.
"""

import json
import logging
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from repro_torch.kernels import autotune
from repro_torch.serve.artifact import FactorArtifact
from repro_torch.serve.foldin import FoldInProjector
from repro_torch.serve.mesh import (MeshServer, ServeMesh, ShardedRows,
                                    serve_mesh)
from repro_torch.serve.topk import TopK, topk_rows

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N, K = 400, 72, 6        # m/8 = 50 rows a shard >> any candidate set
METRICS = ("dot", "cosine")


def _data():
    """serve_distributed_checks.py's factors and exact rows, the queries,
    and a W whose rows repeat (every score ties 8 ways; small integers, so
    every score is exact whatever the order of its sum)."""
    rng = np.random.RandomState(11)
    W = rng.rand(M, K).astype(np.float32) + 0.05
    H = rng.rand(K, N).astype(np.float32) + 0.05
    rows = (W[:24] @ H).astype(np.float32)
    Q = np.random.RandomState(12).rand(7, K).astype(np.float32)
    Q6 = np.random.RandomState(13).rand(4, K).astype(np.float32)
    W_tie = np.tile(np.random.RandomState(14).randint(0, 4, (50, K)),
                    (8, 1)).astype(np.float32)
    return W, H, rows, Q, Q6, W_tie


def _cpu_mesh(p):
    return serve_mesh(p, devices=["cpu"] * p)


def _scaled_close(got, want, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=atol)


# ---------------------------------------------------------------------------
# The JAX side: 8 forced host devices, in a fresh interpreter
# ---------------------------------------------------------------------------

def _jax_main(out):
    from repro.util import env
    env.configure(host_device_count=8)        # before any jax import
    import jax
    from repro.serve.artifact import FactorArtifact as JArt
    from repro.serve.foldin import FoldInProjector as JProj
    from repro.serve.topk import topk_rows as jtopk
    from repro.util.compat import make_mesh
    from repro.serve.mesh import serve_mesh as jmesh
    W, H, rows, Q, Q6, W_tie = _data()
    mesh8 = jmesh(8)
    mesh6 = make_mesh((6,), ("serve",), devices=jax.devices()[:6])
    art = JArt.from_factors(W, H, algo="bpp")
    res = {}
    ref = JProj(art, max_batch=32)
    proj = JProj(art.shard(mesh8), max_batch=32, mesh=mesh8)
    feat = JProj(art, max_batch=16, mesh=mesh8, shard="features")
    for b in (3, 8, 24):
        res[f"single_{b}"] = np.asarray(ref.project(rows[:b]))
        res[f"batch_{b}"] = np.asarray(proj.project(rows[:b]))
    for b in (1, 5, 16):
        res[f"features_{b}"] = np.asarray(feat.project(rows[:b]))
    for metric in METRICS:
        for g, gram in (("nogram", None), ("gram", np.asarray(art.gram))):
            tag = f"{metric}_{g}"
            res[f"topk1_{tag}"] = jtopk(W, Q, k=5, gram=gram, metric=metric,
                                        chunk=32)
            for merge in ("tree", "gather"):
                res[f"topk8_{merge}_{tag}"] = jtopk(
                    W, Q, k=5, gram=gram, metric=metric, chunk=32,
                    mesh=mesh8, merge=merge)
    res["topk6_gather"] = jtopk(W, Q6, k=5, chunk=32, mesh=mesh6)
    try:
        jtopk(W, Q6, k=5, chunk=32, mesh=mesh6, merge="tree")
        res["tree6_refused"] = np.asarray(False)
    except ValueError as e:
        res["tree6_refused"] = np.asarray("power-of-two" in str(e))
    Qi = np.round(Q * 4)
    res["tie1"] = jtopk(W_tie, Qi, k=12, chunk=32)
    res["tie8_tree"] = jtopk(W_tie, Qi, k=12, chunk=32, mesh=mesh8,
                            merge="tree")
    flat = {}
    for key, v in res.items():
        if isinstance(v, tuple):
            flat[key + "_s"], flat[key + "_i"] = (np.asarray(v[0]),
                                                  np.asarray(v[1]))
        else:
            flat[key] = np.asarray(v)
    # the sharded artifact round trip, both ways
    sharded = art.shard(mesh8)
    flat["jax_valid_rows"] = np.asarray(sharded.valid_rows)
    flat["jax_padded_rows"] = np.asarray(sharded.W.shape[0])
    sharded.save(os.path.join(out, "jax_art"))
    back = JArt.load(os.path.join(out, "port_art"), mesh=mesh8)
    flat["port_art_valid_rows"] = np.asarray(back.valid_rows)
    flat["port_art_W"] = np.asarray(back.W)[:back.valid_rows]
    np.savez(os.path.join(out, "jax.npz"), **flat)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh"))
    W, H, *_ = _data()
    # the port's sharded artifact, for the JAX side to load
    art = FactorArtifact.from_factors(W, H, algo="bpp", device="cpu")
    art.shard(_cpu_mesh(8)).save(os.path.join(out, "port_art"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr[-4000:]
    with np.load(os.path.join(out, "jax.npz")) as z:
        ref = {key: z[key] for key in z.files}
    return out, ref


@pytest.fixture(scope="module")
def art():
    W, H, *_ = _data()
    return FactorArtifact.from_factors(W, H, algo="bpp", device="cpu")


# ---------------------------------------------------------------------------
# Sharded fold-in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [8, 6, 1])
@pytest.mark.parametrize("shard_art", [False, True])
def test_batch_foldin_matches_single_device_and_jax(jax_runs, art, p,
                                                   shard_art):
    _, ref = jax_runs
    W, _, rows, *_ = _data()
    mesh = _cpu_mesh(p)
    single = FoldInProjector(art, max_batch=32, device="cpu")
    proj = FoldInProjector(art.shard(mesh) if shard_art else art,
                           max_batch=32, mesh=mesh)
    assert all(b % p == 0 for b in proj.buckets)
    for b in (3, 8, 24):
        got = proj.project(rows[:b]).numpy()
        np.testing.assert_allclose(got, single.project(rows[:b]).numpy(),
                                   atol=2e-4, rtol=1e-4)
        _scaled_close(got, ref[f"batch_{b}"], 1e-4)
    if p == 1:
        # one shard is the single-device projection, bit for bit
        np.testing.assert_array_equal(proj.project(rows).numpy(),
                                      single.project(rows).numpy())
    np.testing.assert_allclose(proj.project(rows).numpy(), W[:24],
                               atol=5e-3, rtol=5e-3)


@pytest.mark.parametrize("p", [8, 6, 1])
def test_features_foldin_matches_single_device_and_jax(jax_runs, art, p):
    """N = 72 splits evenly over 8 and 6 feature shards; the padded split
    is test_features_foldin_pads_the_feature_axis's."""
    _, ref = jax_runs
    _, _, rows, *_ = _data()
    single = FoldInProjector(art, max_batch=16, device="cpu")
    proj = FoldInProjector(art, max_batch=16, mesh=_cpu_mesh(p),
                           shard="features")
    for b in (1, 5, 16):
        got = proj.project(rows[:b]).numpy()
        np.testing.assert_allclose(got, single.project(rows[:b]).numpy(),
                                   atol=2e-4, rtol=1e-4)
        _scaled_close(got, ref[f"features_{b}"], 1e-4)


def test_features_foldin_pads_the_feature_axis(art):
    _, _, rows, *_ = _data()
    single = FoldInProjector(art, max_batch=8, device="cpu")
    proj = FoldInProjector(art, max_batch=8, mesh=_cpu_mesh(5),
                           shard="features")
    assert proj._n_run == 75
    np.testing.assert_allclose(proj.project(rows[:7]).numpy(),
                               single.project(rows[:7]).numpy(), atol=2e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("impl", ["scatter", "sorted"])
def test_sharded_sparse_foldin_matches_dense(art, impl):
    from repro_torch.backends import SparseOps
    rng = np.random.RandomState(5)
    dense = (rng.rand(13, N) * (rng.rand(13, N) < 0.3)).astype(np.float32)
    want = FoldInProjector(art, max_batch=16, device="cpu").project(dense)
    proj = FoldInProjector(art, max_batch=16, mesh=_cpu_mesh(8),
                           backend=SparseOps(spmm_impl=impl))
    got = proj.project(torch.from_numpy(dense).to_sparse())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="batch axis"):
        FoldInProjector(art, mesh=_cpu_mesh(2), shard="features").project(
            torch.from_numpy(dense).to_sparse())


def test_mesh_validation(art):
    with pytest.raises(TypeError, match="serve mesh"):
        FoldInProjector(art, mesh=[torch.device("cpu")])
    with pytest.raises(ValueError, match="not both"):
        FoldInProjector(art, mesh=_cpu_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="multiples"):
        FoldInProjector(art, mesh=_cpu_mesh(4), buckets=(2, 4, 256))
    with pytest.raises(ValueError, match="only 2"):
        serve_mesh(3, devices=["cpu", "cpu"])
    mesh = serve_mesh(devices=["cpu"] * 3)
    assert isinstance(mesh, ServeMesh) and mesh.shape == {"serve": 3}
    assert mesh.axis_names == ("serve",) and mesh.size == 3
    assert serve_mesh(2, devices=["cpu"] * 5).size == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serve_mesh(1)


# ---------------------------------------------------------------------------
# Sharded top-k
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("use_gram", [False, True])
@pytest.mark.parametrize("merge", ["tree", "gather", "auto"])
def test_sharded_topk_matches_single_device_and_jax(jax_runs, art, metric,
                                                    use_gram, merge):
    _, ref = jax_runs
    W, _, _, Q, *_ = _data()
    gram = art.gram if use_gram else None
    tag = f"{metric}_{'gram' if use_gram else 'nogram'}"
    Wt = torch.from_numpy(W)
    want_s, want_i = topk_rows(Wt, Q, k=5, gram=gram, metric=metric,
                               chunk=32)
    got_s, got_i = topk_rows(Wt, Q, k=5, gram=gram, metric=metric, chunk=32,
                             mesh=_cpu_mesh(8), merge=merge)
    assert torch.equal(got_i, want_i)
    np.testing.assert_allclose(got_s.numpy(), want_s.numpy(), atol=2e-4,
                               rtol=1e-4)
    jmerge = "tree" if merge == "auto" else merge
    np.testing.assert_array_equal(got_i.numpy(),
                                  ref[f"topk8_{jmerge}_{tag}_i"])
    np.testing.assert_array_equal(want_i.numpy(), ref[f"topk1_{tag}_i"])
    np.testing.assert_allclose(got_s.numpy(), ref[f"topk8_{jmerge}_{tag}_s"],
                               atol=2e-4, rtol=1e-4)


def test_gather_merge_on_non_power_of_two_mesh(jax_runs):
    _, ref = jax_runs
    W, _, _, _, Q6, _ = _data()
    mesh6 = _cpu_mesh(6)
    Wt = torch.from_numpy(W)
    _, want_i = topk_rows(Wt, Q6, k=5, chunk=32)
    got_s, got_i = topk_rows(Wt, Q6, k=5, chunk=32, mesh=mesh6)
    assert torch.equal(got_i, want_i)
    np.testing.assert_array_equal(got_i.numpy(), ref["topk6_gather_i"])
    np.testing.assert_allclose(got_s.numpy(), ref["topk6_gather_s"],
                               atol=2e-4, rtol=1e-4)
    assert bool(ref["tree6_refused"])
    with pytest.raises(ValueError, match="power-of-two"):
        topk_rows(Wt, Q6, k=5, chunk=32, mesh=mesh6, merge="tree")
    with pytest.raises(ValueError, match="merge"):
        topk_rows(Wt, Q6, k=5, chunk=32, mesh=mesh6, merge="ring")


@pytest.mark.parametrize("p,merge", [(8, "tree"), (8, "gather"),
                                     (6, "gather"), (4, "tree")])
def test_ties_resolve_as_the_reference(jax_runs, p, merge):
    """Every score ties 8 ways: the lowest row index wins, as JAX's
    ``lax.top_k`` scan and its sharded tree merge give."""
    _, ref = jax_runs
    *_, Q, _, W_tie = _data()
    Q = np.round(Q * 4)
    got_s, got_i = topk_rows(torch.from_numpy(W_tie), Q, k=12, chunk=32,
                             mesh=_cpu_mesh(p), merge=merge)
    np.testing.assert_array_equal(got_i.numpy(), ref["tie1_i"])
    np.testing.assert_array_equal(got_i.numpy(), ref["tie8_tree_i"])
    one_s, one_i = topk_rows(torch.from_numpy(W_tie), Q, k=12, chunk=32)
    assert torch.equal(one_i, got_i)
    np.testing.assert_allclose(got_s.numpy(), one_s.numpy(), rtol=1e-6)


def test_topk_handle_on_a_mesh(art):
    _, _, rows, *_ = _data()
    X = FoldInProjector(art, max_batch=32, device="cpu").project(rows)
    want = TopK(art, chunk=32).query(X, k=3)
    for p in (8, 6, 1):
        mesh = _cpu_mesh(p)
        for a in (art, art.shard(mesh)):
            got = TopK(a, mesh=mesh, chunk=32).query(X, k=3)
            assert torch.equal(got[1], want[1])
            np.testing.assert_allclose(got[0].numpy(), want[0].numpy(),
                                       atol=1e-5)
    with pytest.raises(ValueError, match="power-of-two"):
        TopK(art, mesh=_cpu_mesh(6), merge="tree")
    with pytest.raises(ValueError, match="own mesh"):
        topk_rows(art.shard(_cpu_mesh(2)).W, X, k=3)


# ---------------------------------------------------------------------------
# Sharded artifacts
# ---------------------------------------------------------------------------

def test_sharded_artifact_save_load_round_trip(jax_runs, art, tmp_path):
    out, ref = jax_runs
    W, *_ = _data()
    mesh8 = _cpu_mesh(8)
    sharded = art.shard(mesh8)
    assert sharded.shape == (M, N) and sharded.valid_rows == M
    assert isinstance(sharded.W, ShardedRows)
    assert sharded.W.shape[0] % 8 == 0 and len(sharded.W.shards) == 8
    assert sharded.W.shape[0] == int(ref["jax_padded_rows"])
    path = sharded.save(str(tmp_path / "art"))
    back = FactorArtifact.load(path, device="cpu")
    assert back.W.shape == (M, K) and back.valid_rows is None
    np.testing.assert_array_equal(back.W.numpy(), W)
    resharded = FactorArtifact.load(path, mesh=mesh8)
    assert resharded.valid_rows == M
    # the JAX package's sharded save loads here, and the port's there
    jback = FactorArtifact.load(os.path.join(out, "jax_art"),
                                mesh=_cpu_mesh(6))
    assert jback.valid_rows == M == int(ref["jax_valid_rows"])
    np.testing.assert_array_equal(jback.W.full("cpu")[:M].numpy(), W)
    assert int(ref["port_art_valid_rows"]) == M
    np.testing.assert_array_equal(ref["port_art_W"], W)
    # pad rows never leak: transposed, evolve and re-sharding see m rows
    t = sharded.transposed()
    assert t.H.shape == (K, M) and t.valid_rows is None
    child = sharded.evolve(rows_absorbed=3)
    assert child.W.shape == (M, K) and child.version == 1
    again = sharded.shard(_cpu_mesh(6))
    assert again.valid_rows == M and again.W.shape[0] == 402
    with pytest.raises(ValueError, match="not both"):
        FactorArtifact.load(path, mesh=mesh8, device="cpu")


# ---------------------------------------------------------------------------
# MeshServer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [8, 1])
def test_mesh_server_end_to_end_with_hot_swap(art, p, caplog):
    """Fold-in codes depend only on H: halving H doubles every code, an
    observable swap effect (2 w_i · H/2 = a_i exactly)."""
    W, H, rows, *_ = _data()
    art2 = FactorArtifact.from_factors(W, (H / 2.0).astype(np.float32),
                                       algo="bpp", device="cpu")
    with MeshServer(art, mesh=_cpu_mesh(p), max_batch=16, chunk=32,
                    max_delay_s=1e-3) as srv:
        futs = [srv.submit(rows[i]) for i in range(10)]
        codes = np.stack([f.result(timeout=60).numpy() for f in futs])
        np.testing.assert_allclose(codes, W[:10], atol=5e-3, rtol=5e-3)
        _, idx = srv.retrieve(rows[:6], k=3)
        assert tuple(idx.shape) == (6, 3)
        assert (idx[:, 0].numpy() == np.arange(6)).all()
        q = srv.query(srv.project(rows[:2]), k=2)
        assert torch.equal(q[1], idx[:2, :2])
        stop = threading.Event()
        errs, served = [], []

        def client():
            while not stop.is_set():
                try:
                    served.append(srv.submit(rows[0]).result(timeout=60))
                except Exception as e:       # noqa: BLE001
                    errs.append(e)
                    return

        threads = [threading.Thread(target=client) for _ in range(3)]
        for t in threads:
            t.start()
        srv.swap(art2.evolve(H=(H / 2.0).astype(np.float32)))
        stop.set()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not errs, errs
        assert srv.version == 1
        code = srv.submit(rows[0]).result(timeout=60).numpy()
        np.testing.assert_allclose(code, 2.0 * W[0], atol=1e-2, rtol=5e-3)
        # a lineage moves forward only: version 0 after 1 is refused, logged
        with caplog.at_level(logging.INFO, logger="repro_torch.serve.mesh"):
            with pytest.raises(ValueError, match="stale swap"):
                srv.swap(art)
        rec = [r for r in caplog.records if r.event == "swap_refused"]
        assert rec and rec[-1].fields["served_version"] == 1
        assert rec[-1].fields["offered_version"] == 0
        assert srv.version == 1


def test_mesh_server_swaps_from_a_path(art, tmp_path):
    W, _, rows, *_ = _data()
    path = art.evolve().save(str(tmp_path / "v1"))
    with MeshServer(art, mesh=_cpu_mesh(4), max_batch=8, chunk=32,
                    warmup=False) as srv:
        srv.swap(path)
        assert srv.version == 1
        assert isinstance(srv.artifact.W, ShardedRows)
        np.testing.assert_allclose(srv.project(rows[:2]).numpy(), W[:2],
                                   atol=5e-3, rtol=5e-3)


# ---------------------------------------------------------------------------
# The measured top-k tile (kernels/autotune)
# ---------------------------------------------------------------------------

@pytest.fixture()
def tuned_cache(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(autotune.CACHE_ENV, str(path))
    autotune.clear()
    yield path
    autotune.clear()


def test_topk_chunk_autotune(tuned_cache):
    """tests/test_serve.py::test_topk_chunk_autotune on the port."""
    m = 2500
    rng = np.random.RandomState(3)
    W = torch.from_numpy(rng.rand(m, K).astype(np.float32))
    Q = rng.rand(5, K).astype(np.float32)
    ref_s, ref_i = topk_rows(W, Q, k=4, metric="dot")
    got_s, got_i = topk_rows(W, Q, k=4, metric="dot", chunk=None)
    assert torch.equal(got_i, ref_i)
    np.testing.assert_allclose(got_s.numpy(), ref_s.numpy(), atol=1e-5)
    key_parts = (m, K, 5, 4, "dot")
    cached = autotune.lookup("topk_chunk", key_parts, "cpu")
    assert cached is not None and 1 <= cached[0] <= m
    key = autotune.make_key("topk_chunk", key_parts, "cpu")
    assert key == f"topk_chunk|{m}|{K}|5|4|dot|cpu"
    entry = json.loads(tuned_cache.read_text())[key]
    assert set(entry) == {"params", "times_us", "chosen_us"}
    times = entry["times_us"]
    default_key = str((min(4096, m),))
    assert default_key in times                # the hand default ran
    assert times[str(tuple(entry["params"]))] <= times[default_key]
    assert entry["chosen_us"] == min(times.values())
    again_s, _ = topk_rows(W, Q, k=4, metric="dot", chunk=None)
    np.testing.assert_allclose(again_s.numpy(), ref_s.numpy(), atol=1e-5)


def test_topk_chunk_autotune_mangled_entry_reads_as_a_miss(tuned_cache,
                                                           monkeypatch):
    m = 1500
    rng = np.random.RandomState(4)
    W = torch.from_numpy(rng.rand(m, K).astype(np.float32))
    Q = rng.rand(3, K).astype(np.float32)
    want = topk_rows(W, Q, k=3, metric="cosine")
    topk_rows(W, Q, k=3, metric="cosine", chunk=None)
    key = autotune.make_key("topk_chunk", (m, K, 3, 3, "cosine"), "cpu")
    calls = []
    real = autotune.measure
    monkeypatch.setattr(autotune, "measure",
                        lambda run, **kw: calls.append(1) or real(run, **kw))
    for mangled in ({"params": [7, 7]}, {"times_us": {}}, "junk",
                    {"params": []}):
        data = json.loads(tuned_cache.read_text())
        data[key] = mangled
        tuned_cache.write_text(json.dumps(data))
        autotune.clear()
        got = topk_rows(W, Q, k=3, metric="cosine", chunk=None)
        assert torch.equal(got[1], want[1])
    assert calls, "a mangled entry must re-tune"
    healed = json.loads(tuned_cache.read_text())[key]["params"]
    assert len(healed) == 1 and 1 <= healed[0] <= m
    n_calls = len(calls)
    autotune.clear()
    topk_rows(W, Q, k=3, metric="cosine", chunk=None)
    assert len(calls) == n_calls              # healed: a hit again
    tuned_cache.write_text("{not json")
    autotune.clear()
    topk_rows(W, Q, k=3, metric="cosine", chunk=None)
    json.loads(tuned_cache.read_text())       # rewritten as valid JSON


def test_topk_chunk_autotune_on_a_mesh_and_small_w(tuned_cache, art):
    _, _, rows, *_ = _data()
    X = FoldInProjector(art, max_batch=32, device="cpu").project(rows)
    want = TopK(art, chunk=32).query(X, k=3)
    got = TopK(art, mesh=_cpu_mesh(8), chunk=None).query(X, k=3)
    assert torch.equal(got[1], want[1])
    # 50 rows a shard: every candidate clips to 50, so nothing is measured
    assert json.loads(tuned_cache.read_text() if tuned_cache.exists()
                      else "{}") == {}
    assert autotune.tune("op", (1,), [(1,)], lambda c: None) == (1,)
    with pytest.raises(ValueError):
        autotune.tune("op", (1,), [], lambda c: None)


def test_autotune_cache_path_and_measure(tmp_path, monkeypatch):
    monkeypatch.delenv(autotune.CACHE_ENV, raising=False)
    assert str(autotune.cache_path()).endswith(
        os.path.join(".cache", "repro_torch", "autotune.json"))
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path / "x.json"))
    assert autotune.cache_path() == tmp_path / "x.json"
    ran = []
    t = autotune.measure(lambda: ran.append(1), repeats=3)
    assert t >= 0 and len(ran) == 4           # one warm-up, three timed


if __name__ == "__main__":
    _jax_main(sys.argv[1])
