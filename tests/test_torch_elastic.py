"""The port's elastic runtime (``repro_torch.elastic``): segmented training,
checkpoint integrity, fault injection, resume semantics and re-meshing —
the cases of tests/test_elastic.py, on the CPU path — and the checkpoints
crossing packages both ways (the JAX package's ``ElasticRunner`` and
``load_checkpoint`` against the port's).

Serial runs go in this process; the grid runs (faun 2×2 / 1×4 / 4×1,
gspmd 2×2 and naive p = 2 on gloo ranks) are spawned once per module, and
their results are read by the parametrised cases.  A grid resume is held
bit for bit against the port's own uninterrupted run on the same grid, and
within a scaled 1e-4 against the JAX package's serial engine (the
reference's own multi-device driver, test_elastic_distributed_checks,
fails in the reference and is no oracle).  This module imports no JAX at
its top: the spawned ranks never import it.
"""

import functools
import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import blocksparse as bs
from repro_torch.core.engine import NMFSolver
from repro_torch.core.faun import make_faun_grid
from repro_torch.core.rules import AcceleratedHALSRule, AcceleratedMURule, \
    BPPRule, HALSRule, MURule
from repro_torch.elastic import (CheckpointMismatch, ElasticRunner,
                                 FaultPlan, InjectedFault, RetryPolicy,
                                 TransientFault, corrupt_payload,
                                 load_checkpoint, remesh_solver, torn_save,
                                 truncate_payload)
from repro_torch.util import dist as rdist

torch.set_num_threads(1)

SEED = 11
M, N, K = 48, 32, 4
RNG = np.random.RandomState(4)
A = (RNG.rand(M, K) @ RNG.rand(K, N) + 0.01 * RNG.rand(M, N)) \
    .astype(np.float32)
# the grid problem: noisy (rel err ≈ 0.1), so the JAX comparisons sit far
# above fp32 cancellation in the byproduct error
GM, GN = 64, 48
GRNG = np.random.default_rng(5)
GA = (GRNG.uniform(size=(GM, K)) @ GRNG.uniform(size=(K, GN))
      + 0.5 * GRNG.uniform(size=(GM, GN))).astype(np.float32)
GW0 = GRNG.uniform(0.1, 1.0, size=(GM, K)).astype(np.float32)
GH0 = GRNG.uniform(size=(K, GN)).astype(np.float32)


def _solver(schedule="serial", **kw):
    kw.setdefault("algo", "amu")
    kw.setdefault("max_iters", 12)
    kw.setdefault("device", "cpu")
    return NMFSolver(K, schedule=schedule, **kw)


def _same(res, ref, what=""):
    assert torch.equal(res.W, ref.W), what
    assert torch.equal(res.H, ref.H), what
    assert torch.equal(res.rel_errors, ref.rel_errors), what
    assert res.iters == ref.iters, what


def _crash(solver, d, at, A_=A, **fit_kw):
    fit_kw.setdefault("seed", SEED)
    with pytest.raises(InjectedFault):
        ElasticRunner(solver, str(d), segment_iters=4,
                      fault_plan=FaultPlan(crash_at=(at,))).fit(A_, **fit_kw)


# ------------------------------------------------------- segmented == fit

@pytest.mark.parametrize("algo", ["mu", "hals", "bpp", "amu", "ahals"])
def test_uninterrupted_segmented_run_matches_fit(algo, tmp_path):
    ref = _solver(algo=algo).fit(A, seed=SEED)
    res = ElasticRunner(_solver(algo=algo), str(tmp_path),
                        segment_iters=4).fit(A, seed=SEED)
    _same(res, ref, algo)
    assert res.extras["rule_state"] == ref.extras["rule_state"]


@pytest.mark.parametrize("boundary", [4, 8])
@pytest.mark.parametrize("algo", ["mu", "amu", "ahals"])
def test_killed_at_every_segment_boundary_resumes_bit_identical(
        algo, boundary, tmp_path):
    ref = _solver(algo=algo).fit(A, seed=SEED)
    _crash(_solver(algo=algo), tmp_path, boundary)
    runner = ElasticRunner(_solver(algo=algo), str(tmp_path),
                           segment_iters=4)
    res = runner.fit(A)
    _same(res, ref, f"{algo}@{boundary}")
    assert res.extras["rule_state"] == ref.extras["rule_state"]
    assert runner.restores.value == 1


def test_resume_restores_rule_state_not_just_factors(tmp_path):
    _crash(_solver(), tmp_path, 8)
    res = ElasticRunner(_solver(), str(tmp_path), segment_iters=4).fit(A)
    ref = _solver().fit(A, seed=SEED)
    for field in ("inner_w", "inner_h"):
        assert int(res.extras["rule_state"][field]) == \
            int(ref.extras["rule_state"][field])
    # saved as the reference saves them: int32 0-d arrays
    arrays, _ = ckpt.read_payload(str(tmp_path / "step_00000008"))
    assert arrays["rule::inner_w"].dtype == np.int32
    assert arrays["rule::inner_w"].shape == ()


def test_bf16_carry_resumes_bit_identical(tmp_path):
    A16 = torch.from_numpy(A).to(torch.bfloat16)
    ref = _solver(algo="mu").fit(A16, seed=SEED)
    _crash(_solver(algo="mu"), tmp_path, 4, A_=A16)
    arrays, meta = ckpt.read_payload(str(tmp_path / "step_00000004"))
    assert meta["dtype"] == "bfloat16" and arrays["W"].dtype == np.float32
    res = ElasticRunner(_solver(algo="mu"), str(tmp_path),
                        segment_iters=4).fit(A16)
    assert res.W.dtype == torch.bfloat16
    _same(res, ref)


def test_adaptive_tol_honoured_at_segment_granularity(tmp_path):
    solver = NMFSolver(K, algo="mu", max_iters=200, tol=0.3, device="cpu")
    res = ElasticRunner(solver, str(tmp_path), segment_iters=5).fit(
        A, seed=SEED)
    assert res.iters < 200 and res.iters % 5 == 0
    assert float(res.rel_errors[-1]) <= 0.3
    assert res.extras["stopped_early"]


def test_stall_honoured_at_segment_granularity(tmp_path):
    solver = NMFSolver(K, algo="mu", max_iters=300, stall_iters=3,
                       stall_tol=1e-3, device="cpu")
    res = ElasticRunner(solver, str(tmp_path), segment_iters=5).fit(
        A, seed=SEED)
    plain = solver.fit(A, seed=SEED)
    # the runner stops at the first boundary at or after the plain stop
    assert plain.iters <= res.iters < plain.iters + 5
    assert torch.equal(res.rel_errors[:plain.iters], plain.rel_errors)


# ----------------------------------------------------------- fault chaos

def test_corrupt_checkpoint_falls_back_to_previous_step(tmp_path):
    ref = _solver(algo="mu").fit(A, seed=SEED)
    plan = FaultPlan(corrupt_at=(8,), crash_at=(8,))
    with pytest.raises(InjectedFault):
        ElasticRunner(_solver(algo="mu"), str(tmp_path), segment_iters=4,
                      fault_plan=plan).fit(A, seed=SEED)
    runner = ElasticRunner(_solver(algo="mu"), str(tmp_path),
                           segment_iters=4)
    res = runner.fit(A)                  # resumes from step 4, not 8
    _same(res, ref)
    assert runner.corrupt_payloads.value == 1


def test_truncated_checkpoint_falls_back_to_previous_step(tmp_path):
    ref = _solver(algo="mu").fit(A, seed=SEED)
    plan = FaultPlan(truncate_at=(8,), crash_at=(8,))
    with pytest.raises(InjectedFault):
        ElasticRunner(_solver(algo="mu"), str(tmp_path), segment_iters=4,
                      fault_plan=plan).fit(A, seed=SEED)
    runner = ElasticRunner(_solver(algo="mu"), str(tmp_path),
                           segment_iters=4)
    _same(runner.fit(A), ref)
    assert runner.corrupt_payloads.value == 1


def test_torn_save_recovered_on_resume(tmp_path):
    ref = _solver(algo="mu").fit(A, seed=SEED)
    plan = FaultPlan(torn_at=(8,), crash_at=(8,))
    with pytest.raises(InjectedFault):
        ElasticRunner(_solver(algo="mu"), str(tmp_path), segment_iters=4,
                      fault_plan=plan).fit(A, seed=SEED)
    assert not os.path.exists(str(tmp_path / "step_00000008"))
    runner = ElasticRunner(_solver(algo="mu"), str(tmp_path),
                           segment_iters=4)
    _same(runner.fit(A), ref)
    assert runner.recovered_payloads.value == 1


def test_transient_faults_retried_then_succeed(tmp_path):
    ref = _solver(algo="mu").fit(A, seed=SEED)
    runner = ElasticRunner(_solver(algo="mu"), str(tmp_path),
                           segment_iters=4,
                           fault_plan=FaultPlan(transient_at={4: 2}),
                           retry=RetryPolicy(max_retries=3, backoff_s=0.0))
    _same(runner.fit(A, seed=SEED), ref)
    assert runner.retries.value == 2


def test_retry_budget_exhaustion_raises(tmp_path):
    runner = ElasticRunner(_solver(algo="mu"), str(tmp_path),
                           segment_iters=4,
                           fault_plan=FaultPlan(transient_at={0: 5}),
                           retry=RetryPolicy(max_retries=1))
    with pytest.raises(TransientFault):
        runner.fit(A, seed=SEED)
    assert runner.retries.value == 1


@pytest.mark.parametrize("fault", ["corrupt", "truncate", "torn"])
def test_payload_faults_on_their_own(fault, tmp_path):
    path = str(tmp_path / "step_00000004")
    ckpt.write_payload(path, {"a": np.zeros((64,), np.float32)}, {"step": 4})
    if fault == "torn":
        torn_save(path)
        assert not os.path.exists(path)
        assert ckpt.recover_payload(path)
        assert ckpt.read_payload(path)[1]["step"] == 4
        assert not ckpt.recover_payload(path)
        return
    (corrupt_payload if fault == "corrupt" else truncate_payload)(path)
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.read_payload(path)


# -------------------------------------------------- fingerprint enforcement

def test_fingerprint_mismatch_refuses_resume(tmp_path):
    ElasticRunner(_solver(algo="mu"), str(tmp_path),
                  segment_iters=6).fit(A, seed=SEED)
    with pytest.raises(CheckpointMismatch, match="'k'"):
        ElasticRunner(NMFSolver(5, algo="mu", max_iters=12, device="cpu"),
                      str(tmp_path), segment_iters=6).fit(A)
    with pytest.raises(CheckpointMismatch, match="'rule'"):
        ElasticRunner(_solver(algo="hals"), str(tmp_path),
                      segment_iters=6).fit(A)
    with pytest.raises(CheckpointMismatch, match="'rule'"):
        ElasticRunner(_solver(algo=MURule(l1=0.1)), str(tmp_path),
                      segment_iters=6).fit(A)


def test_stateless_rule_refuses_a_rule_state(tmp_path):
    s = _solver(algo="mu")
    rs = s.prepare_state(A, seed=SEED)
    with pytest.raises(ValueError, match="stateless"):
        s.restore_carry(rs, rule_state={"inner_w": 3, "inner_h": 3})


def test_remesh_solver_preserves_the_problem_identity():
    s = NMFSolver(K, algo="amu", max_iters=20, tol=1e-5, device="cpu")
    r = remesh_solver(s, backend="dense")
    assert r.config_fingerprint()["rule"] == s.config_fingerprint()["rule"]
    assert r.config_fingerprint()["k"] == K and r.backend == "dense"
    assert r.stopping == s.stopping and r.schedule == "serial"
    assert r.device == s.device


# -------------------------------------------------------- load/lineage

def test_load_checkpoint_and_to_result(tmp_path):
    ElasticRunner(_solver(algo="mu", max_iters=10), str(tmp_path),
                  segment_iters=5).fit(A, seed=SEED)
    ck = load_checkpoint(str(tmp_path))
    assert ck.step == 10 and ck.W.shape == (M, K)
    assert ck.fingerprint["algo"] == "mu" and ck.meta["seed"] == SEED
    res = ck.to_result()
    assert res.iters == 10 and res.extras["restored_step"] == 10
    warm = _solver(algo="mu", max_iters=2).fit(A, init=res)
    assert warm.rel_errors[0] <= res.rel_errors[-1] * 1.01


def test_load_checkpoint_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "nope"))


def test_reblockify_strips_padding_and_preserves_values():
    D = RNG.rand(64, 48).astype(np.float32)
    D[D < 0.8] = 0.0
    Dt = torch.from_numpy(D)
    fresh = bs.blockify(Dt, 2, 4)
    for blk in (bs.blockify(Dt, 4, 2),
                bs.blockify(Dt, 4, 2).sort_rows(align=64),
                bs.blockify(Dt, 4, 2).sort_rows(align=64, orient="cols")):
        re = bs.blockify(blk, 2, 4)
        np.testing.assert_allclose(re.todense().numpy(), D)
        assert re.vals.shape[-1] == fresh.vals.shape[-1]


def test_elastic_sparse_resume(tmp_path):
    """The sparse backend through kill/resume: A is blocked again on
    restore."""
    Asp = torch.from_numpy(np.where(A > np.median(A), A, 0.0)).to_sparse()
    mk = lambda: NMFSolver(K, algo="mu", backend="sparse", max_iters=8,
                           device="cpu")
    ref = mk().fit(Asp, seed=SEED)
    _crash(mk(), tmp_path, 4, A_=Asp)
    _same(ElasticRunner(mk(), str(tmp_path), segment_iters=4).fit(Asp), ref)


# ------------------------------------------------------- observability

def test_runner_emits_metrics_events_and_spans(tmp_path, caplog):
    from repro_torch.obs import Tracer
    tracer = Tracer()
    runner = ElasticRunner(_solver(algo="mu"), str(tmp_path),
                           segment_iters=4, tracer=tracer)
    with caplog.at_level(logging.INFO,
                         logger="repro_torch.elastic.runner"):
        runner.fit(A, seed=SEED)
    assert runner.saves.value == 3
    assert runner.ckpt_block_seconds.count == 3
    events = [r.event for r in caplog.records if hasattr(r, "event")]
    assert "run_started" in events and "checkpoint_saved" in events
    names = {s.name for s in tracer.spans()}
    assert {"elastic.segment", "elastic.save"} <= names
    tracer = Tracer()
    ElasticRunner(_solver(algo="mu"), str(tmp_path), segment_iters=4,
                  tracer=tracer).fit(A, max_iters=16)
    assert "elastic.restore" in {s.name for s in tracer.spans()}


def test_keep_last_prunes_old_checkpoints(tmp_path):
    ElasticRunner(_solver(algo="mu", max_iters=20), str(tmp_path),
                  segment_iters=4, keep_last=2).fit(A, seed=SEED)
    steps = sorted(d for d in os.listdir(str(tmp_path))
                   if d.startswith("step_"))
    assert steps == ["step_00000016", "step_00000020"]


def test_a_failed_async_write_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    runner = ElasticRunner(_solver(algo="mu"), str(blocker / "ck"),
                           segment_iters=4)
    with pytest.raises(OSError):
        runner.fit(A, seed=SEED)


# ------------------------------------------------ across the two packages

def _jax_rule_specs():
    """(JAX rule, port rule) pairs over every registered name and the
    parameters that enter the identity."""
    from repro.core import rules as jr
    names = ["mu", "hals", "bpp", "abpp", "anls", "amu", "ahals"]
    pairs = [(jr.get_rule(n), n) for n in names]
    pairs += [(jr.MURule(l1=0.1, l2=0.25), MURule(l1=0.1, l2=0.25)),
              (jr.HALSRule(l2=1), HALSRule(l2=1)),
              (jr.BPPRule(max_iter=7, l1=0.5), BPPRule(max_iter=7, l1=0.5)),
              (jr.AcceleratedMURule(inner_iters=None, delta=0.0),
               AcceleratedMURule(inner_iters=None, delta=0.0)),
              (jr.AcceleratedHALSRule(inner_iters=3, fold_delta=1e-4),
               AcceleratedHALSRule(inner_iters=3, fold_delta=1e-4))]
    return pairs


def test_rule_fingerprints_equal_the_jax_packages():
    from repro.core.engine import NMFSolver as JaxSolver
    for jrule, trule in _jax_rule_specs():
        want = JaxSolver(K, algo=jrule).config_fingerprint()
        got = NMFSolver(K, algo=trule, device="cpu").config_fingerprint()
        assert got["rule"] == want["rule"], (got["rule"], want["rule"])
        assert set(got) == set(want)
        assert got["k"] == want["k"] and got["algo"] == want["algo"]


def test_a_users_rule_names_its_own_module():
    class Mine(MURule):
        name = "mine"
    fp = NMFSolver(K, algo=Mine(), device="cpu").config_fingerprint()
    assert fp["rule"].startswith(f"{__name__}.")


@functools.cache
def _jax_fit(algo, iters):
    import jax
    import jax.numpy as jnp
    from repro.core.engine import NMFSolver as JaxSolver
    res = JaxSolver(K, algo=algo, max_iters=iters).fit(
        jnp.asarray(A), key=jax.random.PRNGKey(SEED))
    return res


@pytest.mark.parametrize("algo", ["mu", "amu"])
def test_a_jax_checkpoint_resumes_in_the_port(algo, tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.core.engine import NMFSolver as JaxSolver
    from repro.elastic import ElasticRunner as JaxRunner
    from repro.elastic import FaultPlan as JaxPlan
    from repro.elastic import InjectedFault as JaxFault
    with pytest.raises(JaxFault):
        JaxRunner(JaxSolver(K, algo=algo, max_iters=12), str(tmp_path),
                  segment_iters=4, fault_plan=JaxPlan(crash_at=(4,))).fit(
            jnp.asarray(A), key=jax.random.PRNGKey(SEED))
    arrays, meta = ckpt.read_payload(str(tmp_path / "step_00000004"))
    assert "prng_key" in arrays                # the reference's; ignored
    runner = ElasticRunner(_solver(algo=algo), str(tmp_path),
                           segment_iters=4)
    res = runner.fit(A)
    assert runner.restores.value == 1 and res.iters == 12
    # bit-equal to the port's own run from the checkpointed factors
    own = _solver(algo=algo, max_iters=8).fit(A, W0=arrays["W"],
                                              H0=arrays["H"])
    assert torch.equal(res.W, own.W) and torch.equal(res.H, own.H)
    assert torch.equal(res.rel_errors[4:], own.rel_errors)
    np.testing.assert_array_equal(res.rel_errors[:4].numpy(),
                                  arrays["rel_errors"])
    if algo == "amu":
        for f in ("inner_w", "inner_h"):
            assert res.extras["rule_state"][f] == \
                int(arrays[f"rule::{f}"]) + own.extras["rule_state"][f]
    # and within a scaled 1e-4 of the JAX package's uninterrupted run
    ref = _jax_fit(algo, 12)
    np.testing.assert_allclose(res.rel_errors.numpy(),
                               np.asarray(ref.rel_errors), rtol=1e-4)
    for got, want in ((res.W, ref.W), (res.H, ref.H)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy() / np.abs(want).max(),
                                   want / np.abs(want).max(), atol=1e-4)


@pytest.mark.parametrize("algo", ["mu", "amu"])
def test_a_port_checkpoint_resumes_in_the_jax_package(algo, tmp_path):
    import jax.numpy as jnp
    from repro.core.engine import NMFSolver as JaxSolver
    from repro.elastic import ElasticRunner as JaxRunner
    from repro.elastic import load_checkpoint as jax_load
    _crash(_solver(algo=algo), tmp_path, 8)
    ck = jax_load(str(tmp_path))
    assert ck.step == 8 and ck.W.shape == (M, K)
    assert ck.fingerprint["algo"] == algo
    runner = JaxRunner(JaxSolver(K, algo=algo, max_iters=12), str(tmp_path),
                       segment_iters=4)
    res = runner.fit(jnp.asarray(A))
    assert runner.restores.value == 1 and int(res.iters) == 12
    ours = _solver(algo=algo).fit(A, seed=SEED)
    np.testing.assert_allclose(np.asarray(res.rel_errors),
                               ours.rel_errors.numpy(), rtol=1e-4)
    if algo == "amu":
        st = res.extras["rule_state"]
        assert int(st["inner_w"]) == ours.extras["rule_state"]["inner_w"]


def test_each_package_refuses_the_others_under_another_k_or_rule(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.core.engine import NMFSolver as JaxSolver
    from repro.elastic import CheckpointMismatch as JaxMismatch
    from repro.elastic import ElasticRunner as JaxRunner
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    ElasticRunner(_solver(algo="mu"), str(port_dir), segment_iters=6).fit(
        A, seed=SEED)
    JaxRunner(JaxSolver(K, algo="mu", max_iters=12), str(jax_dir),
              segment_iters=6).fit(jnp.asarray(A),
                                   key=jax.random.PRNGKey(SEED))
    for bad in (dict(k=K + 1, algo="mu"), dict(k=K, algo="hals"),
                dict(k=K, algo="bpp")):
        with pytest.raises(JaxMismatch):
            JaxRunner(JaxSolver(bad["k"], algo=bad["algo"], max_iters=12),
                      str(port_dir), segment_iters=6).fit(jnp.asarray(A))
        with pytest.raises(CheckpointMismatch):
            ElasticRunner(NMFSolver(bad["k"], algo=bad["algo"],
                                    max_iters=12, device="cpu"),
                          str(jax_dir), segment_iters=6).fit(A)
    with pytest.raises(JaxMismatch):      # l1 changes the identity too
        from repro.core.rules import MURule as JaxMU
        JaxRunner(JaxSolver(K, algo=JaxMU(l1=0.1), max_iters=12),
                  str(port_dir), segment_iters=6).fit(jnp.asarray(A))


def test_a_jax_bf16_payload_fails_its_checksum_in_both_packages(tmp_path):
    """The JAX package writes a bf16 factor as ml_dtypes' bfloat16, which
    numpy loads back as raw ``|V2`` bytes whose dtype string no longer
    matches the recorded ``<V2`` checksum: its own restore scan skips it as
    corrupt (a reference caveat), and the port's does the same."""
    import jax
    import jax.numpy as jnp
    from repro.core.engine import NMFSolver as JaxSolver
    from repro.elastic import ElasticRunner as JaxRunner
    from repro.elastic import FaultPlan as JaxPlan
    from repro.elastic import InjectedFault as JaxFault
    A16 = jnp.asarray(A).astype(jnp.bfloat16)
    with pytest.raises(JaxFault):
        JaxRunner(JaxSolver(K, algo="mu", max_iters=8), str(tmp_path),
                  segment_iters=4, fault_plan=JaxPlan(crash_at=(4,))).fit(
            A16, key=jax.random.PRNGKey(SEED))
    with open(tmp_path / "step_00000004" / "meta.json") as f:
        assert json.load(f)["checksums"]["W"].split(":")[2] == "<V2"
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.read_payload(str(tmp_path / "step_00000004"))
    runner = ElasticRunner(_solver(algo="mu", max_iters=8), str(tmp_path),
                           segment_iters=4)
    res = runner.fit(torch.from_numpy(A).to(torch.bfloat16), seed=SEED)
    assert runner.corrupt_payloads.value == 1 and runner.restores.value == 0
    assert res.iters == 8 and res.W.dtype == torch.bfloat16


# ---------------------------------------------------- grids (gloo ranks)

GRID_ALGOS = ["mu", "amu"]


def _save_res(out, tag, res, **extra):
    if dist.get_rank() != 0:
        return
    st = res.extras["rule_state"] or {}
    np.savez(os.path.join(out, f"{tag}.npz"), W=res.W.numpy(),
             H=res.H.numpy(), rels=res.rel_errors.numpy(), iters=res.iters,
             inner_w=st.get("inner_w", -1), inner_h=st.get("inner_h", -1),
             **extra)


def _grid_solver(schedule, shape=None, **kw):
    kw.setdefault("max_iters", 12)
    kw.setdefault("backend", "dense" if schedule == "gspmd" else "cuda")
    grid = None if schedule == "naive" else make_faun_grid(*shape)
    return NMFSolver(K, schedule=schedule, grid=grid, device="cpu", **kw)


def _kill_and_resume(out, tag, mk, boundaries=(4, 8), fit_kw=None):
    """The uninterrupted run, then a kill at each boundary and a resume:
    both saved for the parent to compare; the runners' counters too."""
    fit_kw = fit_kw or dict(W0=GW0, H0=GH0)
    _save_res(out, f"{tag}_ref", mk().fit(GA, **fit_kw))
    for b in boundaries:
        d = os.path.join(out, f"ck_{tag}_{b}")
        try:
            ElasticRunner(mk(), d, segment_iters=4,
                          fault_plan=FaultPlan(crash_at=(b,))).fit(
                GA, **fit_kw)
        except InjectedFault:
            pass
        runner = ElasticRunner(mk(), d, segment_iters=4)
        res = runner.fit(GA)
        _save_res(out, f"{tag}_kill{b}", res,
                  restores=runner.restores.value,
                  reinits=runner.residual_reinits.value)


def _grid4_rank(out):
    rank = dist.get_rank()
    for algo in GRID_ALGOS:
        _kill_and_resume(out, f"faun2x2_{algo}",
                         lambda: _grid_solver("faun", (2, 2), algo=algo))
        _kill_and_resume(out, f"gspmd2x2_{algo}",
                         lambda: _grid_solver("gspmd", (2, 2), algo=algo))
    # a torn save and a corrupt payload on the grid: rank 0 alone repairs
    # and scans, every rank resumes from the step it chose
    for fault in ("torn", "corrupt"):
        d = os.path.join(out, f"ck_{fault}")
        plan = FaultPlan(crash_at=(8,), **{f"{fault}_at": (8,)})
        try:
            ElasticRunner(_grid_solver("faun", (2, 2), algo="mu"), d,
                          segment_iters=4, fault_plan=plan).fit(
                GA, W0=GW0, H0=GH0)
        except InjectedFault:
            pass
        runner = ElasticRunner(_grid_solver("faun", (2, 2), algo="mu"), d,
                               segment_iters=4)
        _save_res(out, f"faun2x2_{fault}", runner.fit(GA),
                  recovered=runner.recovered_payloads.value,
                  corrupt=runner.corrupt_payloads.value)
    # remesh 2×2 → 1×4 → 4×1 (mu: exact wire, bit-identical per grid)
    d = os.path.join(out, "ck_remesh")
    for shape, crash in (((2, 2), 4), ((1, 4), 8), ((4, 1), None)):
        plan = FaultPlan(crash_at=(crash,)) if crash else None
        try:
            res = ElasticRunner(_grid_solver("faun", shape, algo="mu"), d,
                                segment_iters=4, fault_plan=plan).fit(
                GA, W0=GW0, H0=GH0)
        except InjectedFault:
            continue
    _save_res(out, "remesh_final", res)
    # the segment 8 → 12 on 4×1, run plainly from the step-8 checkpoint
    arrays, _ = ckpt.read_payload(os.path.join(d, "step_00000008"))
    _save_res(out, "remesh_plain_4x1",
              _grid_solver("faun", (4, 1), algo="mu", max_iters=4).fit(
                  GA, W0=arrays["W"], H0=arrays["H"]))
    # serial ↔ faun: a serial checkpoint (written by the parent) resumed
    # on the 2×2 grid
    res = ElasticRunner(_grid_solver("faun", (2, 2), algo="mu"),
                        os.path.join(out, "ck_serial"),
                        segment_iters=4).fit(GA)
    _save_res(out, "serial_to_faun", res)
    # int8 residuals: restored on the same grid, re-zeroed on another
    kw = dict(algo="mu", panel_compression="int8")
    _kill_and_resume(out, "int8_2x2",
                     lambda: _grid_solver("faun", (2, 2), **kw),
                     boundaries=(4,))
    d = os.path.join(out, "ck_int8_2x2_4")
    arrays, _ = ckpt.read_payload(os.path.join(d, "step_00000004"))
    if rank == 0:
        np.savez(os.path.join(out, "int8_arrays.npz"),
                 **{k: v for k, v in arrays.items() if k.startswith("res")})
    shutil.rmtree(os.path.join(d, "step_00000012"), ignore_errors=True)
    shutil.rmtree(os.path.join(d, "step_00000008"), ignore_errors=True)
    dist.barrier()
    runner = ElasticRunner(_grid_solver("faun", (1, 4), **kw), d,
                           segment_iters=4)
    _save_res(out, "int8_remesh", runner.fit(GA),
              reinits=runner.residual_reinits.value)


def _grid2_rank(out):
    for algo in GRID_ALGOS:
        _kill_and_resume(out, f"naive2_{algo}",
                         lambda: _grid_solver("naive", algo=algo))


@pytest.fixture(scope="module")
def grid_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("elastic_grid"))
    # the serial checkpoint the grid resumes, and the faun one serial will
    ElasticRunner(NMFSolver(K, algo="mu", max_iters=12, device="cpu"),
                  os.path.join(out, "ck_serial"), segment_iters=4,
                  fault_plan=None).fit(GA, W0=GW0, H0=GH0, max_iters=4)
    rdist.spawn(_grid4_rank, 4, out, backend="gloo", device="cpu")
    rdist.spawn(_grid2_rank, 2, out, backend="gloo", device="cpu")
    return out


def _load(out, tag):
    with np.load(os.path.join(out, f"{tag}.npz")) as z:
        return {key: z[key] for key in z.files}


@functools.cache
def _jax_serial(algo, iters=12):
    import jax.numpy as jnp
    from repro.core.engine import NMFSolver as JaxSolver
    res = JaxSolver(K, algo=algo, backend="dense", max_iters=iters).fit(
        jnp.asarray(GA), W0=jnp.asarray(GW0), H0=jnp.asarray(GH0))
    return {"W": np.asarray(res.W), "H": np.asarray(res.H),
            "rels": np.asarray(res.rel_errors)}


def _assert_like_jax(got, algo):
    want = _jax_serial(algo)
    np.testing.assert_allclose(got["rels"], want["rels"], rtol=1e-4)
    for f in ("W", "H"):
        scale = np.abs(want[f]).max()
        np.testing.assert_allclose(got[f] / scale, want[f] / scale,
                                   atol=1e-4)


def _assert_bits(got, want):
    for f in ("W", "H", "rels", "iters", "inner_w", "inner_h"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("boundary", [4, 8])
@pytest.mark.parametrize("algo", GRID_ALGOS)
@pytest.mark.parametrize("grid", ["faun2x2", "gspmd2x2", "naive2"])
def test_grid_killed_at_every_boundary_resumes_bit_identical(
        grid_runs, grid, algo, boundary):
    ref = _load(grid_runs, f"{grid}_{algo}_ref")
    got = _load(grid_runs, f"{grid}_{algo}_kill{boundary}")
    _assert_bits(got, ref)
    assert int(got["restores"]) == 1
    _assert_like_jax(got, algo)


@pytest.mark.parametrize("fault", ["torn", "corrupt"])
def test_grid_payload_faults_are_handled_once(grid_runs, fault):
    got = _load(grid_runs, f"faun2x2_{fault}")
    _assert_bits(got, _load(grid_runs, "faun2x2_mu_ref"))
    assert int(got["recovered" if fault == "torn" else "corrupt"]) == 1


def test_remesh_2x2_to_1x4_to_4x1(grid_runs):
    got = _load(grid_runs, "remesh_final")
    # the last segment is the 4×1 grid's own run from the checkpoint
    plain = _load(grid_runs, "remesh_plain_4x1")
    np.testing.assert_array_equal(got["W"], plain["W"])
    np.testing.assert_array_equal(got["H"], plain["H"])
    np.testing.assert_array_equal(got["rels"][8:], plain["rels"])
    _assert_like_jax(got, "mu")


def test_serial_checkpoint_resumes_on_a_grid_and_back(grid_runs, tmp_path):
    to_faun = _load(grid_runs, "serial_to_faun")
    _assert_like_jax(to_faun, "mu")
    serial = NMFSolver(K, algo="mu", max_iters=12, device="cpu").fit(
        GA, W0=GW0, H0=GH0)
    np.testing.assert_array_equal(to_faun["rels"][:4],
                                  serial.rel_errors[:4].numpy())
    # a grid checkpoint (the 2×2 faun run killed at 8) resumed serially
    d = tmp_path / "ck"
    shutil.copytree(os.path.join(grid_runs, "ck_faun2x2_mu_8"), d)
    shutil.rmtree(d / "step_00000012", ignore_errors=True)
    arrays, meta = ckpt.read_payload(str(d / "step_00000008"))
    assert meta["fingerprint"]["grid"] == [2, 2]
    res = ElasticRunner(NMFSolver(K, algo="mu", max_iters=12,
                                  device="cpu"), str(d),
                        segment_iters=4).fit(GA)
    own = NMFSolver(K, algo="mu", max_iters=4, device="cpu").fit(
        GA, W0=arrays["W"], H0=arrays["H"])
    assert torch.equal(res.W, own.W) and torch.equal(res.H, own.H)
    _assert_like_jax({"W": res.W.numpy(), "H": res.H.numpy(),
                      "rels": res.rel_errors.numpy()}, "mu")


def test_int8_residuals_restored_on_the_same_grid(grid_runs):
    ref = _load(grid_runs, "int8_2x2_ref")
    got = _load(grid_runs, "int8_2x2_kill4")
    _assert_bits(got, ref)
    assert int(got["reinits"]) == 0
    res = _load(grid_runs, "int8_arrays")
    # the reference's stacked layout: (pr, pc, rows, k)
    assert res["res::gather_w"].shape == (2, 2, GM // 4, K)
    assert res["res::rs_w"].shape == (2, 2, GM // 2, K)
    assert res["res::gram_w"].shape == (2, 2, K, K)
    assert any(np.abs(v).max() > 0 for v in res.values())


def test_int8_residuals_rezeroed_and_counted_on_another_grid(grid_runs):
    got = _load(grid_runs, "int8_remesh")
    assert int(got["reinits"]) == 1 and int(got["iters"]) == 12
    ref = _load(grid_runs, "int8_2x2_ref")
    assert np.isfinite(got["W"]).all() and np.isfinite(got["H"]).all()
    # within the compression tolerance of the uninterrupted run
    np.testing.assert_allclose(got["rels"], ref["rels"], rtol=5e-2)
