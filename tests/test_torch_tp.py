"""Tensor and sequence parallelism over "model" (``models.transformer.
Runtime``, ``distributed.tensor_parallel``, ``sharding.compute_spec``) on
four gloo ranks of the CPU, against the port's single-device model and
against the JAX package's ``jitted_train_step(seq_parallel=True)``.

One spawn of four ranks per module (``util.dist.spawn(..., backend=
"gloo", device="cpu")``) computes everything the tests read, on the
("data", "model") meshes (1, 4) and (2, 2), with ``seq_parallel`` off and
on, for the families of tests/test_torch_train_dist.py plus reduced
smollm, qwen2, granite (MQA), yi-34b (7 heads, 1 KV head: 2/2/2/1 on
(1, 4), 4/3 on (2, 2)) and a two-head whisper-base (1/1/0/0 on (1, 4):
two ranks hold no heads) (fp32; MoE at no-drop capacity with the
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
* the projections computed on the rank's whole heads
  (``sharding.head_range``: 1/tp of them where they divide, unevenly
  elsewhere) and 1/tp of the FFN columns where they divide (whole
  elsewhere), decode caches holding L/tp of the KV length;
* prefill and three decode steps with the KV length split over "model"
  (a distributed flash-decode) against the single-device decode, within a
  scaled 1e-5; recurrentgemma's local-attention ring also at prompts 40
  and 70 (S mod W ≠ 0; 70 does not divide 4, so ``seq_parallel`` drops
  the split there, as the reference's constraint does);
* the vocabulary-parallel cross entropy and its gradient against the
  whole-vocabulary one, within 1e-6;
* the recurrent mixers (reduced recurrentgemma-9b: 64 RG-LRU channels,
  split on both meshes; reduced xlstm-125m: 2 heads, its cells split
  1/1 on (2, 2), 1/1/0/0 on (1, 4)): each rank's leaf widths and decode
  caches, and each mixer's forward collectives (``util.wire.
  record_wire``).

The JAX side runs reduced qwen2's, recurrentgemma's, xlstm's and yi's
train steps on 4 forced host devices in a fresh interpreter (this file
runs itself as a script), from the state it writes with
``repro.checkpoint.save``, and ``jax.grad`` of that state on the batch;
the ranks restore both, run the port's 2 × 2 ``seq_parallel`` step on
the same batch and hold its loss at the same tolerance (qwen2's and
yi's parameters too), its gradient norm within a relative 1e-4 and its
gradient shards within a scaled 1e-4 (yi: the reference splits its 112
query columns mid-head, 3.5 heads a rank; the port by whole heads).
"""

import dataclasses
import math
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
#: reduced whisper-base with two heads (head_dim 32): on (1, 4) two
#: ranks hold none of its encoder's, self- and cross-attention's heads
WHISPER_2H = "whisper_base_2h"
ARCHS = FAMILIES + ("smollm_135m", "qwen2_72b", "granite_20b", "yi_34b",
                    WHISPER_2H)
MESHES = ((1, 4), (2, 2))
B, S = 4, 32
KV_LEN = 80
RING_PROMPTS = (40, 70)
OPT = dict(kind="adamw", lr=1e-3, warmup_steps=1, total_steps=10)
#: the archs whose 2 × 2 seq_parallel step is held against the JAX
#: package's
JAX_ARCHS = ("qwen2_72b", "recurrentgemma_9b", "xlstm_125m", "yi_34b")
#: the archs with recurrent mixers (reduced recurrentgemma-9b: d = 64,
#: split on both meshes; reduced xlstm-125m: 2 heads, one a rank on
#: (2, 2), 1/1/0/0 on (1, 4))
REC_ARCHS = ("recurrentgemma_9b", "xlstm_125m")


def _cfg(arch):
    from repro_torch.configs import base as cb
    if arch == WHISPER_2H:
        return cb.get_reduced_config("whisper_base").replace(
            n_heads=2, n_kv=2, head_dim=32)
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
    of ``Runtime.shard``, the query heads' columns (of q) and FFN rows,
    the recurrent mixers' leaves (an xLSTM cell's from ``xlstm_part``),
    and the train step's gradients (``steps.sharded_grads``' shards)."""

    def __init__(self):
        from repro_torch.models import attention, transformer
        from repro_torch.train import steps
        self.mods = (attention, transformer, steps)
        self.act, self.wq, self.ffn, self.grads = [], set(), set(), []
        self.rec = set()
        self._qkv, self._shard, self._ffn, self._grads = (
            attention.qkv, transformer.Runtime.shard, transformer.ffn,
            steps.sharded_grads)
        self._mixer = transformer.rglru_mixer
        self._part = transformer.xlstm_part

        def qkv(p, *a, **k):
            out = self._qkv(p, *a, **k)
            self.wq.add(out[0].shape[2] * out[0].shape[3])
            return out

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
        def rglru_mixer(p, *a, **k):
            self.rec.add(("rglru",) + _rec_widths("rglru", p))
            return self._mixer(p, *a, **k)

        def xlstm_part(p, cfg, kind, rt):
            out = self._part(p, cfg, kind, rt)
            self.rec.add((kind,) + _rec_widths(kind, out[0]))
            return out
        attention.qkv, transformer.Runtime.shard, transformer.ffn = \
            qkv, shard, ffn
        steps.sharded_grads = sharded_grads
        transformer.rglru_mixer = rglru_mixer
        transformer.xlstm_part = xlstm_part

    def close(self):
        attention, transformer, steps = self.mods
        attention.qkv, transformer.Runtime.shard, transformer.ffn = \
            self._qkv, self._shard, self._ffn
        steps.sharded_grads = self._grads
        transformer.rglru_mixer = self._mixer
        transformer.xlstm_part = self._part


#: the recurrent mixers (``transformer.{kind}_mixer``)
RECURRENT = ("rglru", "mlstm", "slstm")


def _rec_widths(kind, p) -> tuple:
    """The widths of a recurrent mixer's leaves as a rank computes with
    them: RG-LRU (wy, wgate, lru/wa's columns, lru/lam, conv/w, wout's
    rows), mLSTM (cell/wq, cell/wk, cell/wv, conv/w, wdown's rows), sLSTM
    (cell/wz, cell/wo, conv/w); an xLSTM cell's as ``xlstm_part`` gives
    them."""
    if kind == "rglru":
        return (p["wy"].shape[-1], p["wgate"].shape[-1],
                p["lru"]["wa"].shape[-1], p["lru"]["lam"].shape[-1],
                p["conv"]["w"].shape[-1], p["wout"].shape[0])
    if kind == "mlstm":
        c = p["cell"]
        return (c["wq"].shape[-1], c["wk"].shape[-1], c["wv"].shape[-1],
                p["conv"]["w"].shape[-1], p["wdown"].shape[0])
    c = p["cell"]
    return (c["wz"].shape[-1], c["wo"].shape[-1], p["conv"]["w"].shape[-1])


def _rec_cache_shapes(caches) -> set:
    """(leaf, shape) of each recurrent layer's decode cache."""
    out = set()
    for layer in caches:
        if any(k in layer for k in ("C", "c", "h")):
            out |= {(k, tuple(t.shape)) for k, t in layer.items()}
    return out


def _serve(cfg, params, batch, rt, prompt, n_steps=3):
    """Prefill ``batch`` then decode ``n_steps`` tokens: (the prefill's
    logits (this rank's rows, whole over "model"), the last position's
    logits of each step over the whole vocabulary, the caches' local KV
    lengths, the recurrent caches' (leaf, shape))."""
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
    return logits, torch.stack(outs), lens, _rec_cache_shapes(caches)


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
            logits, got, lens, rec_caches = _serve(
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
            "ffn": sorted(seen.ffn), "rec": sorted(seen.rec),
            "rec_caches": sorted(rec_caches)}
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
    _, serve, _, _ = _serve(cfg, state["params"], batch, steps.NULL_RT, S)
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
        _, ref, _, _ = _serve(cfg, whole, batch, steps.NULL_RT, prompt)
        for sp in (False, True):
            _, got, _, _ = _serve(cfg, steps.shard_params(whole, mesh), batch,
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


def _wire_cases(mesh) -> dict:
    """Each recurrent mixer's forward collectives over "model" on this
    rank, (op, the elements of the tensor the rank sends) in issue order:
    {(arch, kind, seq_parallel): [...]}, from the first layer of each kind
    of reduced recurrentgemma-9b and xlstm-125m (parameters gathered
    before the count)."""
    from repro_torch.models import transformer
    from repro_torch.train import steps
    from repro_torch.util.convert import stack_params
    from repro_torch.util.wire import record_wire
    from repro_torch.models.lm import LM
    out = {}
    for arch in REC_ARCHS:
        cfg = _cfg(arch)
        whole = stack_params(LM(cfg, device="cpu", seed=0).tree())
        batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
        for sp in (False, True):
            rt = steps.make_runtime(mesh, seq_parallel=sp)
            local = steps._local_rows(batch, mesh)
            model, run = steps._serving(cfg, steps.shard_params(whole, mesh),
                                        rt, local)
            first, n = run.seq_span(S)
            x = 0.1 * torch.randn((B // mesh.size(0), n, cfg.d_model),
                                  generator=torch.Generator().manual_seed(5))
            for kind in dict.fromkeys(cfg.layer_pattern):
                if kind not in RECURRENT:
                    continue
                blk = next(b for b in model.dec.layers() if b.kind == kind)
                p = blk.params(run)
                mixer = getattr(transformer, f"{kind}_mixer")
                with torch.no_grad(), record_wire() as log:
                    mixer(p, x, cfg, mode="train", cache=None, rt=run)
                out[(arch, kind, sp)] = [(c.op, math.prod(c.shape))
                                         for c in log]
    return out


def _jax_case(mesh, jax_dir, arch):
    """The port's 2 × 2 ``seq_parallel`` step of ``arch`` from the JAX
    package's state, against the JAX step's result (the JAX process,
    started with the ranks, writes each arch's metrics last: wait for
    them)."""
    import json
    import time
    out_dir = os.path.join(jax_dir, arch)
    done = os.path.join(out_dir, "metrics.json")
    for _ in range(600):
        if os.path.exists(done):
            break
        time.sleep(1)
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import steps
    cfg = _cfg(arch)
    opt = OptConfig(**OPT)
    with open(done) as f:
        want = json.load(f)
    if "error" in want:
        return {"error": "the JAX side failed"}
    template = steps.init_train_state(cfg, opt, 0, device="cpu")
    state, _ = ckpt.restore(out_dir, template, step=0)
    after, _ = ckpt.restore(out_dir, template, step=1)
    grads, _ = ckpt.restore(out_dir, template, step=2)
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
            "grad_norm": abs(float(md["grad_norm"]) / want["grad_norm"] - 1),
            "rec": sorted(seen.rec), "wq": tuple(sorted(seen.wq))}


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
        for key, ops in _wire_cases(mesh).items():
            res[(shape, "wire") + key] = ops
        if shape == (2, 2):
            for arch in JAX_ARCHS:
                res[("jax", arch)] = _jax_case(mesh, jax_dir, arch)
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
    mesh = make_mesh((2, 2), ("data", "model"))
    opt = jopt.OptConfig(**OPT)
    for arch in JAX_ARCHS:
        arch_dir = os.path.join(out_dir, arch)
        cfg = jcb.get_reduced_config(arch)
        step, ssh = jsteps.jitted_train_step(cfg, opt, mesh,
                                             seq_parallel=True, donate=False)
        state = jsteps.init_train_state(cfg, opt, jax.random.PRNGKey(3))
        jckpt.save(jax.tree.map(np.asarray, state), 0, arch_dir)
        batch = {k: jnp.asarray(v) for k, v in _batch(cfg, seed=7).items()}
        new, metrics = step(jax.device_put(state, ssh), batch)
        jckpt.save(jax.tree.map(np.asarray, new), 1, arch_dir)
        # the gradient of the same state and batch, unsharded, saved as
        # step 2 in the parameters' place
        grads = jax.jit(jax.grad(lambda p: jlm.loss_fn(p, cfg, batch)[0]))(
            state["params"])
        jckpt.save(jax.tree.map(np.asarray, {**state, "params": grads}), 2,
                   arch_dir)
        tmp = os.path.join(arch_dir, "metrics.tmp")
        with open(tmp, "w") as f:
            json.dump({"loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"])}, f)
        os.replace(tmp, os.path.join(arch_dir, "metrics.json"))


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
    """Each rank computes its query projection on its whole heads
    (``head_range``: H/tp where the heads divide, ⌈H/tp⌉ or ⌊H/tp⌋ where
    they do not, none on a rank past the last head), its FFNs on F/tp
    columns where F divides (else all F)."""
    from repro_torch.distributed.sharding import head_range
    cfg = _cfg(arch)
    tp = mesh[1]
    H, hd = cfg.n_heads, cfg.head_dim
    ffn = {cfg.d_ff} if cfg.d_ff and (not cfg.moe.n_experts
                                      or cfg.moe.shared_expert) else set()
    if "slstm" in cfg.layer_pattern:
        ffn.add((4 * cfg.d_model) // 3)
    want_f = sorted(f // tp if f % tp == 0 else f for f in ffn)
    for rank, res in enumerate(ranks):
        h0, h1 = head_range(H, tp, rank % tp)
        r = res[(mesh, arch, False)]
        if "mlstm" not in cfg.layer_pattern:
            assert r["wq"] == [(h1 - h0) * hd], (rank, r["wq"])
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


def _want_rec(cfg, tp, dp, rank):
    """{kind: the widths ``_rec_widths`` reads} and the recurrent caches'
    {(leaf, shape)} rank ``rank`` of "model" on (dp, tp) holds: the
    RG-LRU on lru/tp channels where they divide (else whole), the xLSTM
    cells on the rank's whole heads (``head_range``: H/tp where they
    divide, unevenly or none where they do not; the sLSTM's conv
    whole)."""
    from repro_torch.distributed.sharding import head_range
    D, H = cfg.d_model, cfg.n_heads
    lru = D // tp if D % tp == 0 else D
    h0, h1 = head_range(H, tp, rank)
    d_in = 2 * D
    Bl, w1 = B // dp, cfg.conv_width - 1
    Hl, dm, ds = h1 - h0, d_in // H, D // H
    widths = {"rglru": (lru,) * 6, "mlstm": (Hl * dm,) * 5,
              "slstm": (Hl * ds, Hl * ds, D)}
    caches = {"rglru": {("h", (Bl, lru)), ("conv", (Bl, w1, lru))},
              "mlstm": {("C", (Bl, Hl, dm, dm)), ("n", (Bl, Hl, dm)),
                        ("m", (Bl, Hl)), ("conv", (Bl, w1, Hl * dm))},
              "slstm": {(k, (Bl, Hl, ds)) for k in "cnhm"}
              | {("conv", (Bl, w1, D))}}
    kinds = [k for k in RECURRENT if k in cfg.layer_pattern]
    return ({(k,) + widths[k] for k in kinds},
            set().union(*(caches[k] for k in kinds)))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", REC_ARCHS)
def test_recurrent_leaves_and_caches_split(ranks, mesh, arch):
    """Each rank's RG-LRU leaves and caches on lru/tp channels, its mLSTM
    and sLSTM cells and caches on its whole heads (the sLSTM's conv
    whole): H/tp where the heads divide, one or none where they do not
    (xlstm's 2 heads on (1, 4): 1/1/0/0), in the train step and in
    serving, with seq_parallel off and on."""
    cfg = _cfg(arch)
    dp, tp = mesh
    for rank, res in enumerate(ranks):
        widths, caches = _want_rec(cfg, tp, dp, rank % tp)
        for sp in (False, True):
            r = res[(mesh, arch, sp)]
            assert set(r["rec"]) == widths, (rank, sp, r["rec"])
            assert set(r["rec_caches"]) == caches, (rank, sp,
                                                    r["rec_caches"])


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", REC_ARCHS)
@pytest.mark.parametrize("sp", [False, True])
def test_recurrent_mixer_collectives(ranks, mesh, arch, sp):
    """A recurrent mixer's forward over "model" (``util.wire.record_wire``):
    an RG-LRU or mLSTM one all-gather of its channels (the gates' and
    q/k/v's input) and one all-reduce of its output (under seq_parallel
    the sequence all-gathered first and the output reduce-scattered), an
    sLSTM one all-gather of its heads' outputs.  An xLSTM cell's heads
    gather padded to ⌈H/tp⌉ heads a rank where they do not divide
    (xlstm's 2 heads on (1, 4): each rank sends one head's channels)."""
    cfg = _cfg(arch)
    dp, tp = mesh
    D = cfg.d_model
    rows = B // dp * S                    # the rank's tokens, whole sequence
    most = -(-cfg.n_heads // tp)          # heads a rank sends, padded
    seq = [("all_gather", rows // tp * D)] if sp else []
    out_sum = [("reduce_scatter" if sp else "all_reduce", rows * D)]
    want = {
        "rglru": seq + [("all_gather", rows * D // tp)] + out_sum,
        "mlstm": seq + [("all_gather", rows * most * 2 * D // cfg.n_heads)]
        + out_sum,
        "slstm": seq + [("all_gather", rows * most * D // cfg.n_heads)],
    }
    for res in ranks:
        for kind in RECURRENT:
            if kind in cfg.layer_pattern:
                assert res[(mesh, "wire", arch, kind, sp)] == want[kind], \
                    (kind, res[(mesh, "wire", arch, kind, sp)])


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
    ("smollm_135m", "attn/wq", None, True),      # 9 heads do not: uneven
    ("smollm_135m", "attn/wk", None, True),
    ("smollm_135m", "attn/wo", None, True),
    ("smollm_135m", "ffn/mlp/wo", 0, False),
    ("yi_34b", "attn/wq", None, True),           # 448 columns: 3.5 heads
    ("yi_34b", "attn/wo", None, True),
    ("whisper_base", "attn/bq", None, True),     # 8 heads over 16
    ("whisper_base", "xattn/wo", None, True),
    ("whisper_base", "attn/bo", None, False),
    ("llama4_maverick", "attn/wq", None, True),  # 40 heads over 16
    ("granite_20b", "attn/wk", None, True),      # MQA
    ("llama4_maverick", "ffn/moe/wi_gate", 0, False),
    ("llama4_maverick", "ffn/moe/router", None, False),
    ("llama4_maverick", "ffn/moe/shared/wi_up", 1, False),
    ("recurrentgemma_9b", "wy", 1, False),       # RG-LRU: 4,096 channels
    ("recurrentgemma_9b", "lru/wa", 1, False),
    ("recurrentgemma_9b", "lru/lam", 0, False),
    ("recurrentgemma_9b", "wout", 0, False),
    ("recurrentgemma_9b", "conv/w", 1, False),
    ("xlstm_125m", "cell/wq", None, True),       # 4 heads do not divide
    ("xlstm_125m", "wup", None, True),
    ("xlstm_125m", "cell/wi", None, True),
    ("xlstm_125m", "conv/w", None, True),        # the mLSTM's heads' conv
    ("xlstm_125m", "wdown", None, True),
]


@pytest.mark.parametrize("arch,leaf,dim,partial", COMPUTE_CASES)
def test_compute_spec_at_the_production_tp(arch, leaf, dim, partial):
    """``sharding.compute_spec`` on the 16 × 16 mesh: the leaves a rank
    computes split (as stored) or whole, and whose gradient is a partial
    sum over "model" (a head leaf whose heads do not divide: gathered
    whole, the rank's uneven heads taken); under seq_parallel every whole
    leaf's but the router's."""
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


#: (leaf of xlstm-125m's layer group 0: p0 an mLSTM, p3 an sLSTM block,
#: its compute split at tp = 4, where its 4 heads divide, and its
#: gradient partial over "model" without seq_parallel)
CELL_CASES = [
    ("p0/cell/wq", 1, False),                   # the rank's heads
    ("p0/conv/w", 1, False),
    ("p0/wdown", 0, False),
    ("p0/wup", None, True),                     # gathered, its heads' x_m, z
    ("p0/cell/wi", None, True),                 # stored whole, sliced
    ("p0/cell/bf", None, True),
    ("p3/cell/wz", 1, False),
    ("p3/cell/wo", 1, False),
    ("p3/cell/wf", None, True),
    ("p3/cell/rz", None, True),
    ("p3/cell/bo", None, True),
    ("p3/conv/w", None, False),                 # the sLSTM's conv: whole
    ("p3/ffn_gate", 1, False),
]


@pytest.mark.parametrize("leaf,dim,partial", CELL_CASES)
def test_compute_spec_splits_xlstm_cells_where_heads_divide(leaf, dim,
                                                            partial):
    """xlstm-125m at tp = 4: its cells split by whole heads; the leaves a
    rank takes its heads' columns of are whole with a partial gradient."""
    import types
    from repro_torch.configs import base as cb
    from repro_torch.distributed import sharding as sr
    from repro_torch.models import lm
    from repro_torch.util.convert import stack_params
    cfg = cb.get_config("xlstm_125m")
    mesh = types.SimpleNamespace(shape={"data": 4, "model": 4})
    tree = stack_params(lm.init_params(cfg, 0, device=torch.device("meta")))
    path = ("dec", "groups") + tuple(leaf.split("/"))
    t = tree
    for k in path:
        t = t[k]
    spec = sr.param_pspec(path, t.shape[1:], mesh)
    assert sr.compute_spec(path, spec, cfg, mesh) == (dim, partial)
    if dim is not None:
        assert spec[dim] == "model"
    assert sr.compute_spec(path, spec, cfg, mesh, seq_parallel=True) == (
        dim, dim is None)


@pytest.mark.parametrize("arch,tp,note", [
    ("recurrentgemma_9b", 16, "whole: KV projections (1 KV heads)"),
    ("xlstm_125m", 16, "uneven heads: mLSTM/sLSTM cells 4 over 16 (≤ 1 a "
                       "rank)"),
    ("xlstm_125m", 4, ""),
    ("xlstm_125m", 3, "uneven heads: mLSTM/sLSTM cells 4 over 3 (≤ 2 a "
                      "rank); whole: sLSTM FFN"),   # 1,024 columns
    ("smollm_135m", 16, "uneven heads: attention 9 over 16 (≤ 1 a rank); "
                        "whole: KV projections (3 KV heads)"),
    ("yi_34b", 16, "uneven heads: attention 56 over 16 (≤ 4 a rank); "
                   "whole: KV projections (8 KV heads)"),
    ("llama4_maverick", 16, "uneven heads: attention 40 over 16 (≤ 3 a "
                            "rank); whole: KV projections (8 KV heads)"),
    ("whisper_base", 16, "uneven heads: attention 8 over 16 (≤ 1 a rank); "
                         "whole: KV projections (8 KV heads), vocabulary "
                         "(51865)"),
    ("qwen2_72b", 16, "whole: KV projections (8 KV heads)"),
])
def test_tp_note_names_what_stays_whole(arch, tp, note):
    """``roofline.report.tp_note``: the RG-LRU splits over its channels;
    attention and the xLSTM cells run on the rank's whole heads, unevenly
    where the heads do not divide; the KV projections and the vocabulary
    run whole where they do not divide."""
    from repro_torch.configs import base as cb
    from repro_torch.roofline.report import tp_note
    assert tp_note(cb.get_config(arch), tp) == note


#: (n_heads, tp): heads that divide, that do not, and fewer than the ranks
HEAD_SPLITS = [(9, 16), (56, 16), (40, 16), (8, 16), (4, 16), (4, 3),
               (7, 4), (7, 2), (2, 4), (9, 4), (56, 3), (64, 16), (6, 4),
               (4, 4)]


@pytest.mark.parametrize("n_heads,tp", HEAD_SPLITS)
def test_head_range_covers_every_head_once(n_heads, tp):
    """``sharding.head_range``: the ranks' ranges tile 0 … H − 1 in rank
    order, each rank ⌈H/tp⌉ or ⌊H/tp⌋ heads, the larger on the first
    H mod tp ranks; where the heads divide, rank r's are r·H/tp … (the
    storage split)."""
    from repro_torch.distributed.sharding import head_range
    ranges = [head_range(n_heads, tp, r) for r in range(tp)]
    assert [h for a, b in ranges for h in range(a, b)] == list(
        range(n_heads))
    sizes = [b - a for a, b in ranges]
    assert sizes == sorted(sizes, reverse=True)
    assert max(sizes) == -(-n_heads // tp) and min(sizes) == n_heads // tp
    assert sizes.count(-(-n_heads // tp)) == (n_heads % tp or tp)
    if n_heads % tp == 0:
        n = n_heads // tp
        assert ranges == [(r * n, (r + 1) * n) for r in range(tp)]


@pytest.mark.parametrize("n_heads,n_kv,tp,want", [
    (56, 8, 3, [(0, 3), (2, 6), (5, 8)]),      # yi-34b: 19/19/18 heads
    (9, 3, 4, [(0, 1), (1, 2), (1, 3), (2, 3)]),     # smollm-135m
    (7, 1, 4, [(0, 1)] * 4),                   # reduced yi-34b
    (2, 2, 4, [(0, 1), (1, 2), (2, 2), (2, 2)]),     # two heads: none
    (40, 8, 16, [(0, 1), (0, 2), (1, 2), (1, 3), (2, 3), (3, 4), (3, 5),
                 (4, 5), (4, 6), (5, 6), (5, 6), (6, 7), (6, 7), (6, 8),
                 (7, 8), (7, 8)]),              # llama4-maverick: 3s, 2s
])
def test_kv_heads_each_rank_reads(n_heads, n_kv, tp, want):
    """The KV heads [lo, hi) each rank's query heads read (GQA groups of
    H / KH): a group straddles ranks where the heads split unevenly, and
    a rank without query heads reads none."""
    from repro_torch.distributed.sharding import head_range
    from repro_torch.models.attention import kv_heads_of
    got = []
    for r in range(tp):
        h0, h1 = head_range(n_heads, tp, r)
        got.append(kv_heads_of(h0, h1 - h0, n_heads // n_kv))
    assert got == want


def test_seq_parallel_step_matches_jax(ranks):
    """The port's 2 × 2 ``seq_parallel`` step from the JAX package's
    state equals ``jitted_train_step(seq_parallel=True)``'s on 4 forced
    host devices: its loss, its parameters, its gradient norm (relative
    1e-4; AdamW's first update is lr · sign(g), blind to a gradient's
    scale), and each rank's gradient shards against ``jax.grad`` of the
    same state and batch (scaled GRAD_TOL)."""
    for res in ranks:
        r = res[("jax", "qwen2_72b")]
        assert "error" not in r, r
        assert r["loss"] < LOSS_TOL, r
        assert r["params"] < PARAM_TOL, r
        assert r["grad_norm"] < GRAD_NORM_TOL, r
        assert r["grads"] < GRAD_TOL, r


def test_uneven_heads_seq_parallel_step_matches_jax(ranks):
    """``test_seq_parallel_step_matches_jax`` for reduced yi-34b, whose 7
    heads split 4/3 by whole heads on 2 × 2 where the reference splits
    its 112 query columns mid-head (3.5 heads a rank): the loss, the
    parameters, the gradient norm and each gradient shard; each rank
    computed its own whole heads."""
    cfg = _cfg("yi_34b")
    for res in ranks:
        r = res[("jax", "yi_34b")]
        assert "error" not in r, r
        assert r["loss"] < LOSS_TOL, r
        assert r["params"] < PARAM_TOL, r
        assert r["grad_norm"] < GRAD_NORM_TOL, r
        assert r["grads"] < GRAD_TOL, r
    widths = {res[("jax", "yi_34b")]["wq"] for res in ranks}
    assert widths == {(4 * cfg.head_dim,), (3 * cfg.head_dim,)}, widths


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_recurrent_seq_parallel_step_matches_jax(ranks, arch):
    """``test_seq_parallel_step_matches_jax`` for reduced recurrentgemma-9b
    and xlstm-125m, whose recurrent mixers run split on 2 × 2 (64 RG-LRU
    channels, 2 xLSTM heads over 2): the loss, the gradient norm and each
    gradient shard (the parameters after AdamW's sign step are not held:
    the mLSTM's input-gate bias has a gradient that is zero up to
    rounding, its sign rounding's)."""
    cfg = _cfg(arch)
    for res in ranks:
        r = res[("jax", arch)]
        assert "error" not in r, r
        assert r["loss"] < LOSS_TOL, r
        assert r["grad_norm"] < GRAD_NORM_TOL, r
        assert r["grads"] < GRAD_TOL, r
        whole = {"rglru": cfg.d_model, "mlstm": 2 * cfg.d_model,
                 "slstm": cfg.d_model}
        assert r["rec"] and all(w[1] < whole[w[0]] for w in r["rec"]), \
            r["rec"]


if __name__ == "__main__":
    try:
        _jax_main(sys.argv[1])
    except BaseException:
        # the ranks wait for each arch's metrics.json: tell them, then fail
        for arch in JAX_ARCHS:
            arch_dir = os.path.join(sys.argv[1], arch)
            os.makedirs(arch_dir, exist_ok=True)
            if not os.path.exists(os.path.join(arch_dir, "metrics.json")):
                with open(os.path.join(arch_dir, "metrics.json"), "w") as f:
                    f.write('{"error": true}')
        raise
