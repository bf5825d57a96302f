"""Tensor and sequence parallelism over "model" (``models.transformer.
Runtime``, ``distributed.tensor_parallel``, ``sharding.compute_spec``) on
four gloo ranks of the CPU, against the port's single-device model and
against the JAX package's ``jitted_train_step(seq_parallel=True)``.

One spawn of four ranks per module (``util.dist.spawn(..., backend=
"gloo", device="cpu")``) computes everything the tests read, on the
("data", "model") meshes (1, 4) and (2, 2), with ``seq_parallel`` off and
on, for the families of tests/test_torch_train_dist.py plus reduced
smollm, qwen2 and granite (MQA) (fp32; MoE at no-drop capacity with the
load-balance weight 0, as there):

* the forward's logits (the prefill's, gathered over the vocabulary, or
  over the sequence where the vocabulary does not split) within a scaled
  1e-5 of the single-device forward;
* the train step (remat on, so the recompute redoes the forward's
  collectives): loss within 1e-4, each rank's parameter shards within
  5e-4 of the single-device step's, its gradient shards
  (``steps.sharded_grads``) within a scaled 1e-4, every shard of the
  rule's shape;
* under ``seq_parallel`` each rank's ``act_btd`` of (B/dp, S/tp, D);
* the projections computed on 1/tp of the heads and FFN columns where
  they divide (whole elsewhere), decode caches holding L/tp of the KV
  length;
* prefill and three decode steps with the KV length split over "model"
  (a distributed flash-decode) against the single-device decode, within a
  scaled 1e-5; recurrentgemma's local-attention ring also at prompts 40
  and 70 (S mod W ≠ 0; 70 does not divide 4, so ``seq_parallel`` drops
  the split there, as the reference's constraint does);
* the vocabulary-parallel cross entropy and its gradient against the
  whole-vocabulary one, within 1e-6.

The JAX side runs reduced qwen2's train step on 4 forced host devices in
a fresh interpreter (this file runs itself as a script), from the state
it writes with ``repro.checkpoint.save``, and ``jax.grad`` of that state
on the batch; the ranks restore both, run the port's 2 × 2
``seq_parallel`` step on the same batch and hold its loss and parameters
at the same tolerances, its gradient norm within a relative 1e-4 and its
gradient shards within a scaled 1e-4.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.util import dist as rdist

torch.set_num_threads(1)        # the four ranks run beside other workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-4
PARAM_TOL = 5e-4
#: a sharded gradient against the single-device one, scaled by the
#: largest entry (tests/test_torch_train_parity.py's GRAD_TOL)
GRAD_TOL = 1e-4
#: the sharded step's gradient norm against the JAX step's, relative
GRAD_NORM_TOL = 1e-4
FWD_TOL = 1e-5
SERVE_TOL = 1e-5
XENT_TOL = 1e-6
FAMILIES = ("whisper_base", "recurrentgemma_9b", "dbrx_132b", "xlstm_125m",
            "llama32_vision_90b")
ARCHS = FAMILIES + ("smollm_135m", "qwen2_72b", "granite_20b")
MESHES = ((1, 4), (2, 2))
B, S = 4, 32
KV_LEN = 80
RING_PROMPTS = (40, 70)
OPT = dict(kind="adamw", lr=1e-3, warmup_steps=1, total_steps=10)
JAX_ARCH = "qwen2_72b"


def _cfg(arch):
    from repro_torch.configs import base as cb
    cfg = cb.get_reduced_config(arch)
    if cfg.moe.n_experts:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts),
            router_aux_weight=0.0))
    return cfg


def _batch(cfg, S=S, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    batch["labels"][:, -2:] = -1                      # ignored positions
    if cfg.is_encdec:
        batch["enc_frames"] = (0.1 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32)
    if cfg.frontend == "image_patches":
        batch["img_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model))).astype(np.float32)
    return batch


def _scaled(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _bad_shards(state, mesh) -> list:
    """Leaves whose local shape is not the rule's: each dim divided by the
    sizes of the mesh dims its spec names."""
    from repro_torch.distributed import sharding as sr
    from repro_torch.train import steps
    specs = steps.state_specs(state, mesh)
    sizes = sr.mesh_shape(mesh)
    bad = []

    def check(t, spec, _path):
        if t.ndim:
            want = list(t.shape)
            for d, axes in enumerate(spec):
                for a in (() if axes is None else
                          (axes,) if isinstance(axes, str) else axes):
                    want[d] //= sizes[a]
            if list(t.to_local().shape) != want:
                bad.append((tuple(t.shape), spec))
        return t
    steps._zip_specs(check, state, specs)
    return bad


def _shard_diffs(got, want, mesh) -> list:
    """|got − want| max per leaf: ``got`` this rank's shards of a stacked
    parameter tree (DTensors or their local tensors), ``want`` the whole
    tree, of which each leaf's shard under the rule is taken here (no
    collective)."""
    from repro_torch.distributed import sharding as sr
    from repro_torch.train import steps
    out = []

    def diff(w, spec, path):
        g = got
        for k in path:
            g = g[k]
        g = g.to_local() if hasattr(g, "to_local") else g
        out.append(float((g.float() - sr.local_slice(w, spec, mesh)
                          .float()).abs().max()))
        return w
    steps._zip_specs(diff, want, sr.tree_specs(want, mesh, ("params",)))
    return out


def _whole_logits(logits, run, vocab):
    """Logits in ``LM.logits``' layout made whole over "model"."""
    from repro_torch.distributed import tensor_parallel as tp
    if logits.shape[-1] < vocab:
        return tp.all_gather(logits, run.group, 2)
    if run.sp:
        return tp.all_gather(logits, run.group, 1)
    return logits


def _rows(t, mesh):
    """This rank's data rows of a whole (B, ...) tensor."""
    d = mesh.get_local_rank("data")
    n = t.shape[0] // mesh.size(0)
    return t[d * n:(d + 1) * n]


class _Seen:
    """What the model computes with on this rank: ``act_btd``'s shapes out
    of ``Runtime.shard``, the query-projection columns and FFN rows, and
    the train step's gradients (``steps.sharded_grads``' shards)."""

    def __init__(self):
        from repro_torch.models import attention, transformer
        from repro_torch.train import steps
        self.mods = (attention, transformer, steps)
        self.act, self.wq, self.ffn, self.grads = [], set(), set(), []
        self._qkv, self._shard, self._ffn, self._grads = (
            attention.qkv, transformer.Runtime.shard, transformer.ffn,
            steps.sharded_grads)

        def qkv(p, *a, **k):
            self.wq.add(p["wq"].shape[-1])
            return self._qkv(p, *a, **k)

        def shard(rt, x, kind, **k):
            y = self._shard(rt, x, kind, **k)
            if kind == "act_btd":
                self.act.append(tuple(y.shape))
            return y

        def ffn(p, *a, **k):
            self.ffn.add(p["wo"].shape[0])
            return self._ffn(p, *a, **k)

        def sharded_grads(*a, **k):
            out = self._grads(*a, **k)
            self.grads.append(out[2])
            return out
        attention.qkv, transformer.Runtime.shard, transformer.ffn = \
            qkv, shard, ffn
        steps.sharded_grads = sharded_grads

    def close(self):
        attention, transformer, steps = self.mods
        attention.qkv, transformer.Runtime.shard, transformer.ffn = \
            self._qkv, self._shard, self._ffn
        steps.sharded_grads = self._grads


def _serve(cfg, params, batch, rt, prompt, n_steps=3):
    """Prefill ``batch`` then decode ``n_steps`` tokens: (the prefill's
    logits (this rank's rows, whole over "model"), the last position's
    logits of each step over the whole vocabulary, the caches' local KV
    lengths)."""
    from repro_torch.models.transformer import KVShard
    from repro_torch.train import steps
    pb = {k: v for k, v in batch.items() if k != "labels"}
    local = steps._local_rows(pb, rt.mesh) if rt.mesh is not None else pb
    model, run = steps._serving(cfg, params, rt, local)
    logits, caches = model.prefill(local, KV_LEN, rt=run)
    logits = _whole_logits(logits, run, cfg.vocab)
    outs = [logits[:, -1]]
    decode = steps.make_decode_step(cfg, rt=rt)
    nxt = batch["tokens"][:, -1:]
    for i in range(n_steps):
        lg, caches = decode(params, caches, nxt, prompt + i)
        outs.append(lg)
        nxt = (nxt * 7 + 3) % cfg.vocab
    lens = sorted({(c.total, c["k" if "k" in c else "ek"].shape[1])
                   for layer in caches for c in layer.values()
                   if isinstance(c, KVShard)})
    return logits, torch.stack(outs), lens


def _arch_cases(arch, mesh, refs):
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import steps
    cfg = _cfg(arch).replace(remat=True)
    opt = OptConfig(**OPT)
    state, batch, ref = refs[arch]
    out = {}
    for sp in (False, True):
        rt = steps.make_runtime(mesh, seq_parallel=sp)
        seen = _Seen()
        try:
            sd, md = steps.make_train_step(cfg, opt, rt=rt)(
                steps.shard_state(state, mesh), batch)
            act = list(seen.act)
            grads = seen.grads[-1]
            logits, got, lens = _serve(
                cfg, steps.shard_params(state["params"], mesh), batch, rt, S)
        finally:
            seen.close()
        top = max(float(t.abs().max()) for t in
                  torch.utils._pytree.tree_leaves(ref["grads"]))
        out[sp] = {
            "loss": abs(float(md["loss"]) - ref["loss"]),
            "params": max(_shard_diffs(sd["params"], ref["params"], mesh)),
            "finite": all(bool(torch.isfinite(t.to_local()).all()) for t in
                          torch.utils._pytree.tree_leaves(sd["params"])),
            "bad_shards": _bad_shards(sd, mesh),
            "grads": max(_shard_diffs(grads, ref["grads"], mesh)) / top,
            "act_btd": act,
            "forward": _scaled(logits, _rows(ref["logits"], mesh)),
            "serve": _scaled(got, ref["serve"][:, _rows(
                torch.arange(B), mesh)]),
            "cache_lens": lens, "wq": sorted(seen.wq),
            "ffn": sorted(seen.ffn)}
    return out


def _references(arch):
    """The single-device train step, forward and serving of ``arch``."""
    from repro_torch.models.lm import LM
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import steps
    from repro_torch.util.convert import unstack_params
    cfg = _cfg(arch).replace(remat=True)
    opt = OptConfig(**OPT)
    state = steps.init_train_state(cfg, opt, 0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    seen = []
    grads_of = steps.grads_of
    steps.grads_of = lambda *a, **k: seen.append(grads_of(*a, **k)) \
        or seen[-1]
    try:
        sref, mref = steps.make_train_step(cfg, opt)(state, batch)
    finally:
        steps.grads_of = grads_of
    grads = seen[-1][2]
    model = LM(cfg, params=unstack_params(state["params"]))
    with torch.no_grad():
        logits, _, _ = model(batch)
    _, serve, _ = _serve(cfg, state["params"], batch, steps.NULL_RT, S)
    return state, batch, {"loss": float(mref["loss"]),
                          "params": sref["params"], "logits": logits,
                          "grads": grads,
                          "serve": serve}


def _ring_cases(mesh):
    """recurrentgemma's local-attention ring after prompts whose length
    is no multiple of its window W."""
    from repro_torch.models.lm import LM
    from repro_torch.train import steps
    from repro_torch.util.convert import stack_params
    cfg = _cfg("recurrentgemma_9b")
    whole = stack_params(LM(cfg, device="cpu", seed=0).tree())
    out = {}
    for prompt in RING_PROMPTS:
        batch = {k: torch.as_tensor(v)
                 for k, v in _batch(cfg, S=prompt).items()}
        _, ref, _ = _serve(cfg, whole, batch, steps.NULL_RT, prompt)
        for sp in (False, True):
            _, got, _ = _serve(cfg, steps.shard_params(whole, mesh), batch,
                               steps.make_runtime(mesh, seq_parallel=sp),
                               prompt)
            out[(prompt, sp)] = _scaled(got, ref[:, _rows(torch.arange(B),
                                                          mesh)])
    return out


def _xent_case(mesh):
    """The vocabulary-parallel cross entropy's value and gradient against
    the whole vocabulary's (over the model ranks' columns of one logit
    tensor)."""
    from repro_torch.models import lm
    from repro_torch.train import steps
    rt = steps.make_runtime(mesh)
    g = torch.Generator().manual_seed(3)
    V = 512
    logits = 4.0 * torch.randn((2, 16, V), generator=g, dtype=torch.float32)
    labels = torch.randint(0, V, (2, 16), generator=g)
    labels[0, :3] = -1
    whole = logits.clone().requires_grad_(True)
    logz = torch.logsumexp(whole, -1)
    gold = torch.gather(whole, -1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    want = ((logz - gold) * mask).sum() / mask.sum()
    (gw,) = torch.autograd.grad(want, whole)
    n = V // rt.tp
    part = logits[..., rt.tp_rank * n:(rt.tp_rank + 1) * n].clone() \
        .requires_grad_(True)
    logz, gold = lm.vocab_parallel_terms(part, labels, rt)
    got = ((logz - gold) * mask).sum() / mask.sum()
    (gg,) = torch.autograd.grad(got, part)
    return {"loss": abs(float(got) - float(want)),
            "grad": float((gg - gw[..., rt.tp_rank * n:(rt.tp_rank + 1) * n])
                          .abs().max())}


def _jax_case(mesh, jax_dir):
    """The port's 2 × 2 ``seq_parallel`` step from the JAX package's
    state, against the JAX step's result (the JAX process, started with
    the ranks, writes its metrics last: wait for them)."""
    import json
    import time
    done = os.path.join(jax_dir, "metrics.json")
    for _ in range(600):
        if os.path.exists(done):
            break
        time.sleep(1)
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import steps
    cfg = _cfg(JAX_ARCH)
    opt = OptConfig(**OPT)
    template = steps.init_train_state(cfg, opt, 0, device="cpu")
    state, _ = ckpt.restore(jax_dir, template, step=0)
    after, _ = ckpt.restore(jax_dir, template, step=1)
    grads, _ = ckpt.restore(jax_dir, template, step=2)
    with open(done) as f:
        want = json.load(f)
    if "error" in want:
        return {"error": "the JAX side failed"}
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, seed=7).items()}
    step = steps.make_train_step(cfg, opt, rt=steps.make_runtime(
        mesh, seq_parallel=True))
    seen = _Seen()
    try:
        sd, md = step(steps.shard_state(state, mesh), batch)
    finally:
        seen.close()
    top = max(float(t.abs().max()) for t in
              torch.utils._pytree.tree_leaves(grads["params"]))
    return {"loss": abs(float(md["loss"]) - want["loss"]),
            "params": max(_shard_diffs(sd["params"], after["params"], mesh)),
            "grads": max(_shard_diffs(seen.grads[-1], grads["params"],
                                      mesh)) / top,
            "grad_norm": abs(float(md["grad_norm"]) / want["grad_norm"] - 1)}


def _rank_body(out_dir, jax_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    refs = {arch: _references(arch) for arch in ARCHS}
    res = {}
    for shape in MESHES:
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        for arch in ARCHS:
            for sp, r in _arch_cases(arch, mesh, refs).items():
                res[(shape, arch, sp)] = r
        for key, err in _ring_cases(mesh).items():
            res[(shape, "ring") + key] = err
        res[(shape, "xent")] = _xent_case(mesh)
        if shape == (2, 2):
            res["jax"] = _jax_case(mesh, jax_dir)
    torch.save(res, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))


def _jax_main(out_dir):
    import json
    from repro.util import env
    env.configure(host_device_count=4)        # before any jax import
    import jax
    import jax.numpy as jnp
    from repro.checkpoint import checkpoint as jckpt
    from repro.configs import base as jcb
    from repro.models import lm as jlm
    from repro.optim import optimizers as jopt
    from repro.train import steps as jsteps
    from repro.util.compat import make_mesh
    cfg = jcb.get_reduced_config(JAX_ARCH)
    opt = jopt.OptConfig(**OPT)
    mesh = make_mesh((2, 2), ("data", "model"))
    step, ssh = jsteps.jitted_train_step(cfg, opt, mesh, seq_parallel=True,
                                         donate=False)
    state = jsteps.init_train_state(cfg, opt, jax.random.PRNGKey(3))
    jckpt.save(jax.tree.map(np.asarray, state), 0, out_dir)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg, seed=7).items()}
    new, metrics = step(jax.device_put(state, ssh), batch)
    jckpt.save(jax.tree.map(np.asarray, new), 1, out_dir)
    # the gradient of the same state and batch, unsharded, saved as step 2
    # in the parameters' place
    grads = jax.jit(jax.grad(lambda p: jlm.loss_fn(p, cfg, batch)[0]))(
        state["params"])
    jckpt.save(jax.tree.map(np.asarray, {**state, "params": grads}), 2,
               out_dir)
    tmp = os.path.join(out_dir, "metrics.tmp")
    with open(tmp, "w") as f:
        json.dump({"loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"])}, f)
    os.replace(tmp, os.path.join(out_dir, "metrics.json"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp"))
    jax_dir = os.path.join(out, "jax")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    jax = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                            jax_dir], env=env, stdout=subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True)
    try:
        rdist.spawn(_rank_body, 4, out, jax_dir, backend="gloo",
                    device="cpu")
    finally:
        _, err = jax.communicate(timeout=600)
    assert jax.returncode == 0, err[-3000:]
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(4)]


CASES = [(m, a, sp) for m in MESHES for a in ARCHS for sp in (False, True)]
IDS = [f"{m[0]}x{m[1]}-{a}-{'sp' if sp else 'tp'}" for m, a, sp in CASES]


@pytest.mark.parametrize("mesh,arch,sp", CASES, ids=IDS)
def test_forward_matches_single(ranks, mesh, arch, sp):
    for res in ranks:
        assert res[(mesh, arch, sp)]["forward"] <= FWD_TOL, arch


@pytest.mark.parametrize("mesh,arch,sp", CASES, ids=IDS)
def test_train_step_matches_single(ranks, mesh, arch, sp):
    for res in ranks:
        r = res[(mesh, arch, sp)]
        assert r["finite"]
        assert r["loss"] < LOSS_TOL, r
        assert r["params"] < PARAM_TOL, r
        assert r["grads"] <= GRAD_TOL, r
        assert r["bad_shards"] == []


@pytest.mark.parametrize("mesh,arch", [(m, a) for m in MESHES
                                       for a in ARCHS])
def test_act_btd_is_the_ranks_slice_under_seq_parallel(ranks, mesh, arch):
    dp, tp = mesh
    for res in ranks:
        acts = set(res[(mesh, arch, True)]["act_btd"])
        assert acts, arch
        assert acts <= {(B // dp, S // tp, _cfg(arch).d_model)}, acts
        assert set(res[(mesh, arch, False)]["act_btd"]) == {
            (B // dp, S, _cfg(arch).d_model)}


@pytest.mark.parametrize("mesh,arch,sp", CASES, ids=IDS)
def test_prefill_and_decode_match_single(ranks, mesh, arch, sp):
    for res in ranks:
        assert res[(mesh, arch, sp)]["serve"] <= SERVE_TOL, arch


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("prompt", RING_PROMPTS)
@pytest.mark.parametrize("sp", [False, True])
def test_local_attention_ring_decodes_with_the_kv_split(ranks, mesh, prompt,
                                                        sp):
    for res in ranks:
        assert res[(mesh, "ring", prompt, sp)] <= SERVE_TOL


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_projections_split_where_heads_and_columns_divide(ranks, mesh,
                                                          arch):
    """Each rank's query projection has H/tp heads where the heads divide
    (else all H), its FFNs F/tp columns where F divides."""
    cfg = _cfg(arch)
    tp = mesh[1]
    H, hd = cfg.n_heads, cfg.head_dim
    want_q = H * hd // tp if H % tp == 0 else H * hd
    ffn = {cfg.d_ff} if cfg.d_ff and (not cfg.moe.n_experts
                                      or cfg.moe.shared_expert) else set()
    if "slstm" in cfg.layer_pattern:
        ffn.add((4 * cfg.d_model) // 3)
    want_f = sorted(f // tp if f % tp == 0 else f for f in ffn)
    for res in ranks:
        r = res[(mesh, arch, False)]
        if "mlstm" not in cfg.layer_pattern:
            assert r["wq"] == [want_q], r["wq"]
        assert r["ffn"] == want_f, r["ffn"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_caches_hold_their_slice_of_the_kv_length(ranks, mesh, arch):
    cfg = _cfg(arch)
    tp = mesh[1]
    for res in ranks:
        lens = res[(mesh, arch, False)]["cache_lens"]
        if any(k in ("attn", "local_attn", "attn_cross", "xattn")
               for k in cfg.layer_pattern):
            assert lens, arch
        assert all(n * tp == total for total, n in lens), lens


@pytest.mark.parametrize("mesh", MESHES)
def test_vocab_parallel_loss_and_gradient(ranks, mesh):
    for res in ranks:
        r = res[(mesh, "xent")]
        assert r["loss"] <= XENT_TOL and r["grad"] <= XENT_TOL, r


#: (arch, leaf of layer 0, its compute split over "model" at tp = 16
#: (the tensor dim of the per-layer leaf, or None), its gradient partial
#: over "model" without seq_parallel)
COMPUTE_CASES = [
    ("qwen2_72b", "attn/wq", 1, False),          # 64 heads divide 16
    ("qwen2_72b", "attn/wo", 0, False),
    ("qwen2_72b", "attn/wk", None, True),        # 8 KV heads do not
    ("qwen2_72b", "attn/bk", None, True),
    ("qwen2_72b", "ffn/mlp/wi_gate", 1, False),
    ("qwen2_72b", "norm1/scale", None, False),
    ("smollm_135m", "attn/wq", None, False),     # 9 heads do not
    ("smollm_135m", "attn/wk", None, False),
    ("smollm_135m", "ffn/mlp/wo", 0, False),
    ("yi_34b", "attn/wq", None, False),          # 448 columns: 3.5 heads
    ("granite_20b", "attn/wk", None, True),      # MQA
    ("llama4_maverick", "ffn/moe/wi_gate", 0, False),
    ("llama4_maverick", "ffn/moe/router", None, False),
    ("llama4_maverick", "ffn/moe/shared/wi_up", 1, False),
    ("recurrentgemma_9b", "wy", None, False),    # the recurrent mixers
]


@pytest.mark.parametrize("arch,leaf,dim,partial", COMPUTE_CASES)
def test_compute_spec_at_the_production_tp(arch, leaf, dim, partial):
    """``sharding.compute_spec`` on the 16 × 16 mesh: the leaves a rank
    computes split (as stored) or whole, and whose gradient is a partial
    sum over "model"; under seq_parallel every whole leaf's but the
    router's."""
    import types
    from repro_torch.configs import base as cb
    from repro_torch.distributed import sharding as sr
    from repro_torch.models import lm
    from repro_torch.util.convert import stack_params
    cfg = cb.get_config(arch)
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16})
    tree = stack_params(lm.init_params(cfg, 0, device=torch.device("meta")))
    path = ("dec", "groups", "p0") + tuple(leaf.split("/"))
    t = tree
    for k in path:
        t = t[k]
    spec = sr.param_pspec(path, t.shape[1:], mesh)
    assert sr.compute_spec(path, spec, cfg, mesh) == (dim, partial)
    if dim is not None:
        assert spec[dim] == "model"
    sp = sr.compute_spec(path, spec, cfg, mesh, seq_parallel=True)
    assert sp == (dim, dim is None and not leaf.endswith("router"))


def test_seq_parallel_step_matches_jax(ranks):
    """The port's 2 × 2 ``seq_parallel`` step from the JAX package's
    state equals ``jitted_train_step(seq_parallel=True)``'s on 4 forced
    host devices: its loss, its parameters, its gradient norm (relative
    1e-4; AdamW's first update is lr · sign(g), blind to a gradient's
    scale), and each rank's gradient shards against ``jax.grad`` of the
    same state and batch (scaled GRAD_TOL)."""
    for res in ranks:
        r = res["jax"]
        assert "error" not in r, r
        assert r["loss"] < LOSS_TOL, r
        assert r["params"] < PARAM_TOL, r
        assert r["grad_norm"] < GRAD_NORM_TOL, r
        assert r["grads"] < GRAD_TOL, r


if __name__ == "__main__":
    try:
        _jax_main(sys.argv[1])
    except BaseException:
        # the ranks wait for metrics.json: tell them, then fail
        os.makedirs(sys.argv[1], exist_ok=True)
        with open(os.path.join(sys.argv[1], "metrics.json"), "w") as f:
            f.write('{"error": true}')
        raise
