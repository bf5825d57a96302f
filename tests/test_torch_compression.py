"""The port's compressed panel wire (``distributed/compression.py``) on the
CPU: its quantiser against the JAX package's (``Int8PanelCompressor``), the
generic helpers, the solver's refusals, and the reference's own criteria
for compressed fits (tests/test_engine.py's panel-compression cases and
tests/engine_distributed_checks.py's compressed checks) on gloo ranks,
with the wire format each schedule puts on the wire recorded collective by
collective (``util.wire.record_wire``).

Each group is spawned once per module; its ranks write their results to a
temporary directory, which the cases read.  This module imports no JAX at
its top: the spawned ranks never import JAX.
"""

import functools
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core.engine import NMFSolver
from repro_torch.distributed import compression as comp
from repro_torch.util import dist as rdist

M, N, K = 96, 64, 6
RES_KEYS = ["gather_h", "gather_w", "gram_h", "gram_w", "rs_h", "rs_w"]


def _problem(seed=0, noise=0.5, density=None):
    """Low rank plus noise (tests/test_torch_engine.py's problem); noise
    0.01 is the reference's distributed checks' A, and ``density`` keeps
    that share of the entries (their sparse A)."""
    rng = np.random.default_rng(seed)
    A = (rng.uniform(size=(M, K)) @ rng.uniform(size=(K, N))
         + noise * rng.uniform(size=(M, N))).astype(np.float32)
    W0 = rng.uniform(0.1, 1.0, size=(M, K)).astype(np.float32)
    H0 = rng.uniform(size=(K, N)).astype(np.float32)
    if density is not None:
        A[rng.uniform(size=A.shape) >= density] = 0.0
    return A, W0, H0


# ---------------------------------------------------------------------------
# The quantiser against the reference's, in one process
# ---------------------------------------------------------------------------

def _panel(dtype):
    """Columns spread over 1e-6 … 1e3, a zero row, a dead column whose
    carried residual is not zero, signed entries."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, K)) * np.logspace(-6, 3, K)
    x[5] = 0.0
    x[:, 2] = 0.0
    res = rng.standard_normal((64, K)) * np.logspace(-8, 1, K)
    x = torch.from_numpy(x.astype(np.float32)).to(dtype)
    return x, torch.from_numpy(res.astype(np.float32))


def _jax_quantize(fn, x, res):
    import jax.numpy as jnp
    from repro.distributed.compression import Int8PanelCompressor
    c = Int8PanelCompressor({})
    xj = jnp.asarray(x.float().numpy())
    if x.dtype == torch.bfloat16:
        xj = xj.astype(jnp.bfloat16)
    rj = jnp.asarray(res.numpy())
    out = {"ef": lambda: c._ef_quantize(xj, rj),
           "ef_gram": lambda: c._ef_quantize(xj, rj, levels=2.0 ** 23),
           "simulate": lambda: c.simulate(xj, rj),
           "simulate_gram": lambda: c.simulate_gram(xj, rj)}[fn]()
    return [np.asarray(o, np.float32) for o in out]


def _port_quantize(fn, x, res):
    c = comp.Int8PanelCompressor()
    out = {"ef": lambda: c._ef_quantize(x, res),
           "ef_gram": lambda: c._ef_quantize(x, res, levels=2.0 ** 23),
           "simulate": lambda: c.simulate(x, res),
           "simulate_gram": lambda: c.simulate_gram(x, res)}[fn]()
    return [o.numpy() for o in out]


@pytest.mark.parametrize("fn", ["ef", "ef_gram", "simulate",
                                "simulate_gram"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quantiser_matches_the_reference(dtype, fn):
    """``_ef_quantize`` (q, row scales, column scales, new residual) and
    ``simulate`` / ``simulate_gram`` (dequantised value, new residual): q
    identical, the rest within rtol 1e-6 (they read bit-equal here)."""
    x, res = _panel(dtype)
    got, want = _port_quantize(fn, x, res), _jax_quantize(fn, x, res)
    assert len(got) == len(want)
    if fn.startswith("ef"):
        ticks = int(np.count_nonzero(got[0] != want[0]))
        assert ticks == 0, f"{ticks} of {got[0].size} q entries differ"
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    new_res = got[-1]
    assert new_res.dtype == np.float32
    assert np.all(new_res[:, 2] == 0)       # the dead column drops its own
    assert np.all(np.isfinite(new_res)) and np.all(np.isfinite(got[-2]))


def test_a_zero_row_of_a_dead_column_stays_exactly_zero():
    x, res = _panel(torch.float32)
    out, new_res = comp.Int8PanelCompressor().simulate(x, torch.zeros_like(x))
    assert torch.all(out[5] == 0) and torch.all(out[:, 2] == 0)
    assert torch.all(new_res[5] == 0)
    q = comp.Int8PanelCompressor()._ef_quantize(x, res)[0]
    assert q.abs().max() <= 127 and torch.equal(q, torch.round(q))


def test_generic_helpers_match_the_reference():
    """quantize_int8, compress_with_feedback, topk_with_feedback and
    zero_residuals over a nested dict of tensors, against the reference's
    over the same pytree."""
    import jax.numpy as jnp
    from repro.distributed import compression as jcomp
    rng = np.random.default_rng(5)
    arrs = {"a": rng.standard_normal((40,)).astype(np.float32) * 5,
            "b": [rng.standard_normal((8, 3)).astype(np.float32),
                  rng.standard_normal((5,)).astype(np.float32) * 1e-3]}
    res = {"a": rng.standard_normal((40,)).astype(np.float32) * 1e-2,
           "b": [np.zeros((8, 3), np.float32),
                 rng.standard_normal((5,)).astype(np.float32) * 1e-4]}
    t = lambda tree: comp._tree_map(torch.from_numpy, tree)
    j = lambda tree: comp._tree_map(jnp.asarray, tree)
    q, s = comp.quantize_int8(torch.from_numpy(arrs["a"]))
    jq, js = jcomp.quantize_int8(jnp.asarray(arrs["a"]))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
    got = comp.compress_with_feedback(t(arrs), t(res))
    want = jcomp.compress_with_feedback(j(arrs), j(res))
    leaves = lambda tree: [tree["a"]] + list(tree["b"])
    for g_tree, w_tree in zip(got, want):
        for g, w in zip(leaves(g_tree), leaves(w_tree)):
            np.testing.assert_allclose(np.asarray(g, np.float32),
                                       np.asarray(w, np.float32),
                                       rtol=1e-6, atol=0)
    kept, new_res = comp.topk_with_feedback(t(arrs), t(res), frac=0.1)
    jkept, jnew = jcomp.topk_with_feedback(j(arrs), j(res), frac=0.1)
    for g, w in zip(leaves(kept) + leaves(new_res),
                    leaves(jkept) + leaves(jnew)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((kept["a"] != 0).sum()) == 4
    zeros = comp.zero_residuals(t(arrs))
    assert all(z.dtype == torch.float32 and not z.any()
               for z in leaves(zeros))
    assert leaves(zeros)[1].shape == (8, 3)


def test_error_feedback_converges():
    """tests/test_misc_system.py's EF-SGD on a quadratic: int8 steps with
    feedback reach the optimum, and never do worse than without."""
    target = torch.tensor([1.3, -0.7, 2.1, 0.01])

    def run(feedback: bool):
        x = torch.zeros(4)
        r = {"x": torch.zeros(4)}
        for _ in range(300):
            g = {"x": 2 * (x - target)}
            if feedback:
                q, s, r = comp.compress_with_feedback(g, r)
                step = comp.dequantize_int8(q["x"], s["x"])
            else:
                q, s = comp.quantize_int8(g["x"])
                step = comp.dequantize_int8(q, s)
            x = x - 0.05 * step
        return float((x - target).abs().max())

    assert run(True) < 5e-3
    assert run(True) <= run(False) + 1e-6


def test_quantize_roundtrip_error_bound():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(1000)
                         .astype(np.float32)) * 5
    q, s = comp.quantize_int8(x)
    assert float((comp.dequantize_int8(q, s) - x).abs().max()) \
        <= float(s) * 0.5 + 1e-6


# ---------------------------------------------------------------------------
# The solver's refusals and the cost helpers (tests/test_engine.py:326-340)
# ---------------------------------------------------------------------------

def test_panel_compression_validation():
    with pytest.raises(ValueError, match="unknown panel_compression"):
        NMFSolver(4, schedule="faun", panel_compression="fp4", device="cpu")
    with pytest.raises(ValueError, match="serial"):
        NMFSolver(4, schedule="serial", panel_compression="int8",
                  device="cpu")
    with pytest.raises(ValueError, match="do not compose"):
        NMFSolver(4, schedule="faun", panel_compression="int8",
                  panel_dtype=torch.bfloat16, device="cpu")
    with pytest.raises(ValueError, match="unknown panel_compression"):
        comp.get_compressor("int4")


def test_compressed_words_helper():
    assert comp.compressed_words(400.0, rows=10.0) == 110.0
    assert comp.compressed_words(400.0, rows=10.0, scatter=True) == 120.0


def test_profile_is_refused_and_names_its_item():
    """profile=True runs on the exact wire (obs/phases.py); the compressed
    wire is refused on a grid (``_one_rank`` below)."""
    A = _problem()[0]
    res = NMFSolver(K, device="cpu", max_iters=2).fit(A, profile=True)
    assert set(res.extras["phase_times"]) == {
        "gram_w", "mm_w", "luc_w", "gram_h", "mm_h", "luc_h", "error"}


# ---------------------------------------------------------------------------
# Rank bodies
# ---------------------------------------------------------------------------

def _save(out, tag, res):
    rows = {"W": res.W, "H": res.H, "rels": res.rel_errors}
    for key, v in (res.extras.get("panel_residuals") or {}).items():
        rows[f"res_{key}"] = v
    np.savez(os.path.join(out, f"{tag}_r{dist.get_rank()}.npz"),
             iters=res.iters, stopped=res.extras["stopped_early"],
             **{key: v.float().numpy() if isinstance(v, torch.Tensor)
                else v for key, v in rows.items()},
             W_dtype=str(res.W.dtype),
             residual_dtypes=[str(v.dtype) for v in
                         (res.extras.get("panel_residuals") or {}).values()])


def _wire(solver, A, W0, H0):
    """One iteration's collectives, after a first one (steady state)."""
    from repro_torch.util.wire import record_wire
    rs = solver.prepare_state(A, W0=W0, H0=H0)
    solver.run_segment(rs, 1)
    with record_wire() as log:
        solver.run_segment(rs, 1)
    return [(c.op, str(c.dtype).replace("torch.", ""), list(c.shape))
            for c in log]


def _one_rank(out):
    """tests/test_engine.py:343-366 on a 1×1 grid, and the refusals that
    need a process group."""
    from repro_torch.core.faun import make_faun_grid
    A, W0, H0 = _problem()
    grid = make_faun_grid(1, 1)
    kw = dict(algo="mu", schedule="faun", grid=grid, device="cpu")
    _save(out, "one_exact8", NMFSolver(K, max_iters=8, **kw).fit(
        A, W0=W0, H0=H0))
    _save(out, "one_none8", NMFSolver(K, max_iters=8, panel_compression=None,
                                      **kw).fit(A, W0=W0, H0=H0))
    _save(out, "one_exact20", NMFSolver(K, max_iters=20, **kw).fit(
        A, W0=W0, H0=H0))
    _save(out, "one_int8_20", NMFSolver(K, max_iters=20,
                                        panel_compression="int8", **kw).fit(
        A, W0=W0, H0=H0))
    refusals = {}
    solver = NMFSolver(K, panel_compression="int8", **kw)
    for name, call in (("profile", lambda: solver.fit(A, profile=True)),
                       ("lower_step", lambda: solver.lower_step(M, N))):
        try:
            call()
            refusals[name] = "ran"
        except (ValueError, NotImplementedError) as e:
            refusals[name] = f"{type(e).__name__}: {e}"
    np.save(os.path.join(out, "refusals.npy"), refusals)


def _four_ranks(out):
    """tests/engine_distributed_checks.py:294-419 on a 2×2 grid (naive: 4
    ranks), and the wire format of one compressed iteration."""
    from repro_torch.backends import SparseOps
    from repro_torch.core.faun import init_faun_residuals, make_faun_grid
    grid = make_faun_grid(2, 2)
    pods = make_faun_grid(2, 1, pods=2)
    rank = dist.get_rank()
    A, W0, H0 = _problem(noise=0.01)
    # bpp at tol 1e-2: the compressed run within 1.3x the exact iterations
    for sched, kw in (("faun", dict(grid=grid)), ("naive", {}),
                      ("gspmd", dict(grid=grid, backend="dense"))):
        for c in (None, "int8"):
            res = NMFSolver(K, algo="bpp", schedule=sched, max_iters=100,
                            tol=1e-2, panel_compression=c, device="cpu",
                            **kw).fit(A, W0=W0, H0=H0)
            _save(out, f"tol_{sched}_{c}", res)
    # the fixed and the adaptive loop carry the residuals alike
    for name, kw in (("fixed", {}), ("adaptive", dict(tol=1e-12))):
        _save(out, f"loop_{name}", NMFSolver(
            K, algo="mu", schedule="faun", grid=grid, max_iters=6,
            panel_compression="int8", device="cpu", **kw).fit(
                A, W0=W0, H0=H0))
    init = init_faun_residuals(grid, M, N, K)
    np.save(os.path.join(out, f"init_shapes_r{rank}.npy"),
            {key: tuple(v.shape) for key, v in init.items()})
    # bf16 data: bf16 factors, fp32 residuals
    _save(out, "bf16", NMFSolver(
        K, algo="mu", schedule="faun", grid=grid, max_iters=6,
        panel_compression="int8", backend="dense", device="cpu").fit(
            torch.from_numpy(A).to(torch.bfloat16)))
    # the multi-pod grid (JAX pod × pr × pc = 2 × 2 × 1)
    for c in (None, "int8"):
        _save(out, f"pods_{c}", NMFSolver(
            K, algo="mu", schedule="faun", grid=pods, max_iters=10,
            panel_compression=c, device="cpu").fit(A, W0=W0, H0=H0))
    # the sparse backend: compressed faun against the serial exact fit
    As = _problem(noise=0.01, density=0.25)[0]
    sp = dict(algo="mu", backend=SparseOps(spmm_impl="scatter"),
              max_iters=8, device="cpu")
    if rank == 0:
        _save(out, "sparse_serial", NMFSolver(K, **sp).fit(
            As, W0=W0, H0=H0))
    _save(out, "sparse_int8", NMFSolver(
        K, schedule="faun", grid=grid, panel_compression="int8", **sp).fit(
            As, W0=W0, H0=H0))
    # the wire: one compressed iteration of each schedule
    A, W0, H0 = _problem()
    wires = {
        "faun": _wire(NMFSolver(K, algo="hals", schedule="faun", grid=grid,
                                panel_compression="int8", device="cpu"),
                      A, W0, H0),
        "naive": _wire(NMFSolver(K, algo="hals", schedule="naive",
                                 panel_compression="int8", device="cpu"),
                       A, W0, H0),
        "sparse": _wire(NMFSolver(K, algo="mu", schedule="faun", grid=grid,
                                  backend=SparseOps(spmm_impl="sorted"),
                                  panel_compression="int8", device="cpu"),
                        As, W0, H0),
        "faun_exact": _wire(NMFSolver(K, algo="hals", schedule="faun",
                                      grid=grid, device="cpu"), A, W0, H0)}
    np.save(os.path.join(out, f"wire_r{rank}.npy"), wires)
    # the generic int8 mean over the group
    g = {"x": torch.arange(8, dtype=torch.float32) * (rank + 1) - 3.0}
    mean, new_res = comp.compressed_pmean(g, comp.zero_residuals(g))
    np.save(os.path.join(out, f"pmean_r{rank}.npy"),
            np.stack([g["x"].numpy(), mean["x"].numpy(),
                      new_res["x"].numpy()]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("compression"))
    rdist.spawn(_one_rank, 1, out, backend="gloo", device="cpu")
    rdist.spawn(_four_ranks, 4, out, backend="gloo", device="cpu")
    return out


def _load(out, tag, rank=0):
    with np.load(os.path.join(out, f"{tag}_r{rank}.npz")) as z:
        return {key: z[key] for key in z.files}


def _res(got):
    return {key[4:]: v for key, v in got.items() if key.startswith("res_")}


# ---------------------------------------------------------------------------
# tests/test_engine.py:343-366, on one rank
# ---------------------------------------------------------------------------

def test_panel_compression_none_is_bit_identical(runs):
    ref, off = _load(runs, "one_exact8"), _load(runs, "one_none8")
    for key in ("W", "H", "rels"):
        np.testing.assert_array_equal(off[key], ref[key])
    assert not _res(off)


def test_panel_compression_single_rank_faun(runs):
    """A 1×1 grid quantises every panel: the compressed run converges next
    to the exact one and carries nonzero residuals under the six keys."""
    ex, co = _load(runs, "one_exact20"), _load(runs, "one_int8_20")
    assert abs(float(co["rels"][-1]) - float(ex["rels"][-1])) < 5e-3
    res = _res(co)
    assert sorted(res) == RES_KEYS
    assert any(np.abs(v).max() > 0 for v in res.values())
    assert res["rs_w"].shape == (M, K) and res["gather_h"].shape == (N, K)
    assert all(np.isfinite(v).all() for v in res.values())


def test_compressed_solver_refuses_profile_and_lower_step(runs):
    got = np.load(os.path.join(runs, "refusals.npy"), allow_pickle=True)[()]
    assert got["profile"].startswith("ValueError")
    assert "panel_compression" in got["profile"]
    # lower_step is ported (item 12c): a compressed solver counts its step
    assert got["lower_step"] == "ran"


# ---------------------------------------------------------------------------
# tests/engine_distributed_checks.py:294-419, on four ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", ["faun", "naive", "gspmd"])
def test_compressed_panels_reach_exact_tolerance(runs, schedule):
    """bpp at tol 1e-2: both runs stop early, the compressed one at the
    tolerance within 1.3× the exact run's iterations, with finite
    residuals; every rank stops at the same iteration."""
    for r in range(4):
        ex = _load(runs, f"tol_{schedule}_None", r)
        co = _load(runs, f"tol_{schedule}_int8", r)
        assert bool(ex["stopped"]) and bool(co["stopped"])
        assert float(co["rels"][-1]) <= 1e-2
        assert int(co["iters"]) <= int(np.ceil(1.3 * int(ex["iters"])))
        res = _res(co)
        assert res and all(np.isfinite(v).all() for v in res.values())
        assert int(co["iters"]) == int(_load(runs, f"tol_{schedule}_int8",
                                             0)["iters"])


def test_compressed_residual_carry_alike_in_fixed_and_adaptive_loops(runs):
    for r in range(4):
        init = np.load(os.path.join(runs, f"init_shapes_r{r}.npy"),
                       allow_pickle=True)[()]
        fixed, adaptive = _load(runs, "loop_fixed", r), _load(
            runs, "loop_adaptive", r)
        assert int(adaptive["iters"]) == 6
        for got in (fixed, adaptive):
            res = _res(got)
            assert sorted(res) == sorted(init)
            for key in init:
                assert res[key].shape == init[key], key
                assert np.abs(res[key]).max() > 0, key
        np.testing.assert_allclose(fixed["rels"], adaptive["rels"],
                                   atol=1e-6)
        np.testing.assert_allclose(fixed["res_rs_w"], adaptive["res_rs_w"],
                                   atol=1e-6)


def test_compressed_bf16_factor_carry(runs):
    for r in range(4):
        got = _load(runs, "bf16", r)
        assert str(got["W_dtype"]) == "torch.bfloat16"
        assert np.isfinite(got["rels"]).all()
        assert set(got["residual_dtypes"].tolist()) == {"torch.float32"}


def test_compressed_multipod_grid(runs):
    ex, co = _load(runs, "pods_None"), _load(runs, "pods_int8")
    assert abs(float(co["rels"][-1]) - float(ex["rels"][-1])) < 5e-3


def test_compressed_sparse_faun_stays_near_exact(runs):
    ex, co = _load(runs, "sparse_serial"), _load(runs, "sparse_int8")
    assert abs(float(co["rels"][-1]) - float(ex["rels"][-1])) < 5e-3


@functools.cache
def _wires(out):
    return [np.load(os.path.join(out, f"wire_r{r}.npy"),
                    allow_pickle=True)[()] for r in range(4)]


@pytest.mark.parametrize("schedule", ["faun", "naive", "sparse"])
def test_compressed_wire_is_int8_panels_only(runs, schedule):
    """The counterpart of ``compressed_faun_hlo_int8_panels_only``: int8
    all-gathers (and for faun an int8 all-to-all), int32 Gram all-reduces
    (faun), no reduce-scatter at all, fp32 only for 1-D scale vectors, the
    k×k error Grams and scalars, and nothing the size of A's block."""
    a_block = (M // 2) * (N // 2)
    for wire in _wires(runs):
        entries = wire[schedule]
        kinds = {(op, dt) for op, dt, _ in entries}
        assert ("all_gather", "int8") in kinds, kinds
        if schedule != "naive":
            assert ("all_to_all", "int8") in kinds, kinds
            assert ("all_reduce", "int32") in kinds, kinds
        else:
            assert not any(op == "all_to_all" for op, _, _ in entries)
        assert not any(op == "reduce_scatter" for op, _, _ in entries)
        for op, dt, shape in entries:
            if dt in ("int8", "int32"):
                continue
            assert dt == "float32", (op, dt, shape)
            assert len(shape) <= 1 or tuple(shape) == (K, K), (op, shape)
        for op, dt, shape in entries:
            assert int(np.prod(shape)) < a_block, (op, dt, shape)


def test_exact_faun_wire_is_fp32_panels(runs):
    """The same recording of the exact wire: fp32 gathers and
    reduce-scatters, no int8."""
    for wire in _wires(runs):
        kinds = {(op, dt) for op, dt, _ in wire["faun_exact"]}
        assert ("reduce_scatter", "float32") in kinds
        assert ("all_gather", "float32") in kinds
        assert not any(dt in ("int8", "int32") for _, dt in kinds)


def test_compressed_pmean_is_the_int8_mean(runs):
    rows = [np.load(os.path.join(runs, f"pmean_r{r}.npy")) for r in range(4)]
    xs = np.stack([row[0] for row in rows])
    scale = np.float32(np.abs(xs).max() / 127.0 + 1e-30)
    q = np.clip(np.round(xs / scale), -127, 127)
    want = (q.sum(0) / 4).astype(np.float32) * scale
    for r, row in enumerate(rows):
        np.testing.assert_allclose(row[1], want, rtol=1e-6)
        np.testing.assert_allclose(row[2], xs[r] - q[r] * scale, atol=1e-6)
