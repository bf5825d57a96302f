"""The port's training loop, data and CLI, as the reference's tests check
them (tests/test_train_loop.py, tests/test_models.py's train-step cases,
tests/test_misc_system.py's CLI case), on the CPU.

Checkpoint/restart bit-exactness, failure-injection recovery, the
straggler watchdog, the async checkpointer and the seeded loader; five
adamw steps descend for every reduced architecture and five adafactor
steps for qwen2 and llama4; the CLI trains reduced smollm for 60 steps on
the markov task with a clear descent and a checkpoint written, and
restarts from it.
"""

import os
import tempfile
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import base as cb
from repro_torch.data.pipeline import lm_batch, make_lm_loader
from repro_torch.optim.optimizers import OptConfig, tree_leaves, tree_map
from repro_torch.train import steps as steps_lib
from repro_torch.train.loop import (LoopConfig, StragglerWatchdog,
                                    largest_mesh_shape, train)

torch.set_num_threads(1)

CPU = "cpu"


def _setup(tmp, total=12, ckpt_every=4):
    cfg = cb.get_reduced_config("smollm_135m")
    opt = OptConfig(kind="adamw", lr=1e-3, warmup_steps=2, total_steps=total)
    state = steps_lib.init_train_state(cfg, opt, 0, device=CPU)
    step = steps_lib.make_train_step(cfg, opt)

    def batch_fn(s):
        return lm_batch(0, s, batch=4, seq=32, vocab=cfg.vocab, device=CPU)
    loop_cfg = LoopConfig(total_steps=total, ckpt_every=ckpt_every,
                          ckpt_dir=tmp, log_every=100)
    return state, step, batch_fn, loop_cfg


def _tree_equal(a, b) -> bool:
    """Leaf by leaf, matched by key path (a restored dict is in sorted key
    order)."""
    return all(tree_leaves(tree_map(torch.equal, a, b)))


def test_checkpoint_roundtrip_bitexact():
    with tempfile.TemporaryDirectory() as tmp:
        state, *_ = _setup(tmp)
        ckpt_lib.save(state, 3, tmp)
        restored, step = ckpt_lib.restore(tmp, state)
        assert step == 3
        assert _tree_equal(state, restored)


def test_keep_last_prunes():
    with tempfile.TemporaryDirectory() as tmp:
        state, *_ = _setup(tmp)
        for s in [1, 2, 3, 4, 5]:
            ckpt_lib.save(state, s, tmp, keep_last=2)
        steps = sorted(d for d in os.listdir(tmp) if d.startswith("step_"))
        assert steps == ["step_00000004", "step_00000005"]


def test_failure_injection_resumes_bitexact():
    """A synthetic crash at step 6 must give the exact final state of an
    uninterrupted run (pure-function data, checkpointed optimizer)."""
    with tempfile.TemporaryDirectory() as t1:
        state, step, batch_fn, loop_cfg = _setup(t1)
        ref_state, ref_hist = train(state, step, batch_fn, loop_cfg)
    with tempfile.TemporaryDirectory() as t2:
        state, step, batch_fn, loop_cfg = _setup(t2)
        crash_state, hist = train(state, step, batch_fn, loop_cfg,
                                  inject_failure_at=6)
        assert _tree_equal(ref_state["params"], crash_state["params"])
        assert _tree_equal(ref_state["opt"], crash_state["opt"])
        assert int(crash_state["step"]) == int(ref_state["step"]) == 12
        # steps 5 and 6 ran twice: after the crash at 6 the loop resumed
        # from the checkpoint of step 4
        assert [m["step"] for m in hist] == list(range(1, 7)) + list(
            range(5, 13))
        assert hist[-1]["loss"] == ref_hist[-1]["loss"]


def test_async_checkpointer():
    with tempfile.TemporaryDirectory() as tmp:
        state, *_ = _setup(tmp)
        cp = ckpt_lib.AsyncCheckpointer(tmp, keep_last=2)
        cp.save(state, 1)
        cp.save(state, 2)    # joins the first save
        cp.wait()
        assert ckpt_lib.latest_step(tmp) == 2


def test_straggler_watchdog_fires():
    events = []
    wd = StragglerWatchdog(factor=2.0, min_history=3,
                           on_straggler=lambda *a: events.append(a))
    for _ in range(4):                      # build history of fast steps
        wd.step_started(0)
        time.sleep(0.01)
        wd.step_finished(0.01)
    wd.step_started(99)                     # deadline ≈ 0.02s
    time.sleep(0.15)                        # exceed it
    wd.step_finished(0.15)
    assert len(wd.events) == 1
    assert wd.events[0][0] == 99
    assert events == wd.events


def test_straggler_watchdog_quiet_on_normal_steps():
    wd = StragglerWatchdog(factor=5.0, min_history=2)
    for _ in range(5):
        wd.step_started(0)
        time.sleep(0.005)
        wd.step_finished(0.005)
    assert wd.events == []


@pytest.mark.parametrize("arch", ["smollm_135m", "whisper_base",
                                  "llama32_vision_90b"])
def test_data_pipeline_deterministic(arch):
    cfg = cb.get_reduced_config(arch)
    shape = cb.ShapeConfig("t", 32, 4, "train")
    fn = make_lm_loader(cfg, shape, seed=3, device=CPU)
    b1, b2 = fn(7), fn(7)
    assert set(b1) == set(b2)
    for k in b1:
        assert torch.equal(b1[k], b2[k]), k
    b3 = fn(8)
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert b1["tokens"].dtype == torch.int32
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    if cfg.is_encdec:
        assert tuple(b1["enc_frames"].shape) == (4, 32, cfg.d_model)
    if cfg.frontend == "image_patches":
        assert tuple(b1["img_embeds"].shape) == (4, cfg.num_image_tokens,
                                                 cfg.d_model)


def test_copy_task_is_copy():
    b = lm_batch(0, 0, batch=2, seq=16, vocab=97, task="copy", device=CPU)
    toks = b["tokens"].numpy()
    np.testing.assert_array_equal(toks[:, :8], toks[:, 8:16])


@pytest.mark.parametrize("task", ["markov", "uniform"])
def test_other_tasks_are_seeded_tokens(task):
    a = lm_batch(1, 2, batch=3, seq=20, vocab=31, task=task, device=CPU)
    b = lm_batch(1, 2, batch=3, seq=20, vocab=31, task=task, device=CPU)
    assert torch.equal(a["tokens"], b["tokens"])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 31
    assert tuple(a["labels"].shape) == (3, 20)


def test_markov_table_is_fixed_by_its_seed_alone():
    """The markov chain's transitions: the same table for every seed and
    step (tokens that follow a token repeat its favourite successors)."""
    from repro_torch.data.pipeline import _markov_table
    t1 = _markov_table(31, torch.device(CPU))
    t2 = _markov_table(31, torch.device(CPU))
    assert torch.equal(t1, t2)
    b = lm_batch(5, 9, batch=64, seq=64, vocab=31, task="markov",
                 device=CPU)
    prev, nxt = b["tokens"].flatten(), b["labels"].flatten()
    # the empirical successor of each token agrees with the table's argmax
    # more often than chance (1/31)
    hits = (t1.argmax(1)[prev.long()] == nxt.long()).float().mean()
    assert float(hits) > 0.2


def test_restore_none_when_empty():
    with tempfile.TemporaryDirectory() as tmp:
        state, *_ = _setup(tmp)
        restored, step = ckpt_lib.restore(tmp, state)
        assert restored is None and step is None


def test_largest_mesh_shape():
    assert largest_mesh_shape(4, 2) == (2, 2)
    assert largest_mesh_shape(6, 4) == (3, 2)
    assert largest_mesh_shape(7, 2) == (7, 1)
    assert largest_mesh_shape(8) == (8, 1)


# ------------------------------------------------- descent (test_models)

def _batch(cfg):
    rng = np.random.default_rng(0)
    B, S = 2, 32
    batch = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)),
        "labels": torch.as_tensor(
        rng.integers(0, cfg.vocab, (B, S)).astype(np.int32))}
    if cfg.is_encdec:
        batch["enc_frames"] = torch.as_tensor(
            (0.1 * rng.standard_normal((B, S, cfg.d_model)))
            .astype(np.float32))
    if cfg.frontend == "image_patches":
        batch["img_embeds"] = torch.as_tensor(
            (0.1 * rng.standard_normal((B, cfg.num_image_tokens,
                                        cfg.d_model))).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_train_step_descends(arch):
    cfg = cb.get_reduced_config(arch)
    opt = OptConfig(kind="adamw", lr=3e-3, warmup_steps=1, total_steps=20,
                    weight_decay=0.0)
    state = steps_lib.init_train_state(cfg, opt, 0, device=CPU)
    step = steps_lib.make_train_step(cfg, opt)
    batch = _batch(cfg)
    losses = []
    for _ in range(5):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
        assert np.isfinite(float(m["grad_norm"]))
    assert losses[-1] < losses[0], losses    # overfits one batch


@pytest.mark.parametrize("arch", ["qwen2_72b", "llama4_maverick"])
def test_adafactor_variant(arch):
    cfg = cb.get_reduced_config(arch)
    opt = OptConfig(kind="adafactor", lr=1e-2, warmup_steps=1,
                    total_steps=20, weight_decay=0.0)
    state = steps_lib.init_train_state(cfg, opt, 0, device=CPU)
    step = steps_lib.make_train_step(cfg, opt)
    batch = _batch(cfg)
    losses = []
    for _ in range(5):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_train_step_leaves_its_input_state_alone():
    cfg = cb.get_reduced_config("smollm_135m")
    opt = OptConfig(kind="adamw", lr=1e-2, warmup_steps=1, total_steps=5)
    state = steps_lib.init_train_state(cfg, opt, 0, device=CPU)
    before = [t.clone() for t in tree_leaves(state)]
    new, _ = steps_lib.make_train_step(cfg, opt)(state, _batch(cfg))
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(state)))
    assert not _tree_equal(new["params"], state["params"])


def test_train_state_specs_are_meta_and_match_the_state():
    cfg = cb.get_reduced_config("recurrentgemma_9b")
    for kind in ("adamw", "adafactor", "sgd"):
        opt = OptConfig(kind=kind)
        spec = steps_lib.train_state_specs(cfg, opt)
        state = steps_lib.init_train_state(cfg, opt, 0, device=CPU)
        same = tree_map(lambda x, y: x.device.type == "meta"
                        and x.shape == y.shape and x.dtype == y.dtype,
                        spec, state)
        assert len(tree_leaves(spec)) == len(tree_leaves(state))
        assert all(tree_leaves(same))


def test_serve_steps_match_the_model():
    """``make_prefill_step`` / ``make_serve_step`` over a stacked train
    state give the LM's own prefill and greedy decode."""
    cfg = cb.get_reduced_config("smollm_135m")
    state = steps_lib.init_train_state(cfg, OptConfig(), 0, device=CPU)
    model = steps_lib.model_of(cfg, state["params"])
    tokens = _batch(cfg)["tokens"][:, :16]
    last, caches = steps_lib.make_prefill_step(cfg, 20)(
        state["params"], {"tokens": tokens})
    full, _ = model.prefill({"tokens": tokens}, 20)
    assert torch.equal(last, full[:, -1])
    nxt, caches = steps_lib.make_serve_step(cfg)(state["params"], caches,
                                                 last.argmax(-1)[:, None], 16)
    assert nxt.shape == (2, 1) and nxt.dtype == torch.int32


# ------------------------------------------------------------------- CLI

def test_train_cli_end_to_end():
    from repro_torch.launch.train import main as train_main
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--arch", "smollm-135m", "--reduced", "--steps", "60",
                "--batch", "8", "--seq", "32", "--lr", "1e-2", "--task",
                "markov", "--ckpt-dir", tmp, "--ckpt-every", "20",
                "--device", "cpu", "--log-level", "WARNING"]
        hist = train_main(argv)
        assert len(hist) == 60
        # markov is learnable fast: expect clear descent, not noise
        assert hist[-1]["loss"] < hist[0]["loss"] - 0.02
        assert any(d.startswith("step_") for d in os.listdir(tmp))
        # a restart finds step 60 and has nothing left to run
        assert train_main(argv) == []


def test_train_cli_refuses_a_production_mesh_without_its_ranks():
    from repro_torch.launch.train import main as train_main
    from repro_torch.util import dist as rdist
    with rdist.one_rank_group(torch.device(CPU)):
        with pytest.raises(ValueError, match="256"):
            train_main(["--arch", "smollm-135m", "--reduced", "--mesh",
                        "single", "--steps", "1", "--device", "cpu"])
        with pytest.raises(ValueError, match="512"):
            train_main(["--arch", "smollm-135m", "--reduced", "--mesh",
                        "multipod", "--steps", "1", "--device", "cpu"])


def test_train_cli_on_a_mesh_defaults_to_cuda():
    """A mesh does not move the CLI to the CPU: without ``--device cpu``
    it raises on a host with no card, even in a gloo world."""
    from repro_torch.launch.train import main as train_main
    from repro_torch.util import dist as rdist
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with rdist.one_rank_group(torch.device(CPU)):
        with pytest.raises(RuntimeError, match="CUDA"):
            train_main(["--arch", "smollm-135m", "--reduced", "--mesh",
                        "test", "--steps", "1"])


def test_train_cli_refuses_a_world_of_another_backend(monkeypatch):
    """``--device cpu`` trains over gloo: a world joined over NCCL is
    refused, not trained on the CPU."""
    import torch.distributed as dist
    from repro_torch.launch.train import main as train_main
    from repro_torch.util import dist as rdist
    with rdist.one_rank_group(torch.device(CPU)):
        monkeypatch.setattr(dist, "get_backend", lambda *a, **k: "nccl")
        with pytest.raises(RuntimeError, match="over gloo"):
            train_main(["--arch", "smollm-135m", "--reduced", "--mesh",
                        "test", "--steps", "1", "--device", "cpu"])


def test_init_from_env_refuses_cuda_without_a_card(monkeypatch):
    from repro_torch.util import dist as rdist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rdist.init_from_env("cuda")


def test_train_cli_defaults_to_cuda():
    from repro_torch.launch.train import main as train_main
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--arch", "smollm-135m", "--reduced", "--steps", "1"])
