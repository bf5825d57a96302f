"""The port's sharded training on four gloo ranks of the CPU, against its
single-device step (tests/distributed_checks.py's training checks).

One spawn of four ranks per module (``util.dist.spawn(..., backend=
"gloo", device="cpu")``) on a 2 × 2 ("data", "model") mesh computes
everything the tests read:

* the sharded train step of reduced smollm (adamw, and adafactor) against
  the single-device step from the same state and batch: loss within
  1e-4, parameters within 5e-4 (``train_step_sharded_matches_single``),
  and every rank's local shard of every parameter and optimizer leaf of
  the rule's shape;
* one step with two microbatches and remat for each family of
  ``per_arch_sharded_train_lowering`` (whisper, recurrentgemma, dbrx with
  ``moe_ep``, xlstm, llama32-vision): finite, within the same bounds of
  its single-device step.  dbrx is held at no-drop capacity with the
  load-balance weight 0: under expert parallelism the reference's router
  loss is the mean of each token shard's (``pmean``), not the whole
  batch's, so with it on the two steps differ by definition; the loss of
  that run is held against the mean of the shards' losses instead;
* ``moe_ep`` against ``moe_local`` at a generous capacity (atol 2e-5,
  ``moe_ep_matches_local``) on both of its paths;
* the layers gathering their shards on use, again in the remat
  recompute;
* Adafactor on the shards for dbrx and llama4 (expert leaves sharded over
  both dims): parameters, state and shard shapes against the
  single-device step;
* the train loop on the mesh with an injected failure, bit for bit the
  uninterrupted sharded run; the CLI with ``--mesh test``;
* ``elastic_resume`` of that checkpoint onto 2 of the 4 ranks, bit for
  bit, then a step on the new (1, 2) mesh.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.util import dist as rdist

LOSS_TOL = 1e-4
PARAM_TOL = 5e-4
FAMILIES = ("whisper_base", "recurrentgemma_9b", "dbrx_132b", "xlstm_125m",
            "llama32_vision_90b")
ADAFACTOR_MOE = ("dbrx_132b", "llama4_maverick")
#: the optimizer state after a sharded step against the single-device
#: one's, scaled by its largest entry
OPT_TOL = 1e-5


def _batch(cfg, B=8, S=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     dtype=torch.int32),
             "labels": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                     dtype=torch.int32)}
    if cfg.is_encdec:
        batch["enc_frames"] = 0.1 * torch.randn((B, S, cfg.d_model),
                                                generator=g)
    if cfg.frontend == "image_patches":
        batch["img_embeds"] = 0.1 * torch.randn(
            (B, cfg.num_image_tokens, cfg.d_model), generator=g)
    return batch


def _nodrop(cfg, aux_weight=None):
    if not cfg.moe.n_experts:
        return cfg
    kw = {"capacity_factor": float(cfg.moe.n_experts)}
    if aux_weight is not None:
        kw["router_aux_weight"] = aux_weight
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def _max_diff(a, b) -> float:
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    return max(tree_leaves(tree_map(
        lambda x, y: float((x.float() - y.float()).abs().max()), a, b)))


def _compare(cfg, opt, mesh, microbatches=1, seed=0):
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train import steps
    state = steps.init_train_state(cfg, opt, seed, device="cpu")
    batch = _batch(cfg, seed=seed)
    sref, mref = steps.make_train_step(cfg, opt,
                                       microbatches=microbatches)(state,
                                                                  batch)
    sharded = steps.shard_state(state, mesh)
    dstep = steps.make_train_step(cfg, opt, rt=steps.make_runtime(mesh),
                                  microbatches=microbatches)
    sd, md = dstep(sharded, batch)
    full = steps.full_state(sd)
    return {"loss_ref": float(mref["loss"]), "loss": float(md["loss"]),
            "nll_ref": float(mref["nll"]),
            "aux": float(md["aux"]), "nll": float(md["nll"]),
            "grad_norm_ref": float(mref["grad_norm"]),
            "grad_norm": float(md["grad_norm"]),
            "param_diff": _max_diff(sref["params"], full["params"]),
            "opt_diff": _max_diff(sref["opt"], full["opt"]),
            "opt_top": max(float(t.abs().max()) for t in
                           tree_leaves(sref["opt"])),
            "finite": all(bool(torch.isfinite(v).all()) for v in
                          tree_leaves(full["params"])),
            "shards": _shard_report(sd, mesh)}


def _shard_report(state, mesh):
    """(leaves checked, leaves whose local shape is not the rule's: each
    dim divided by the sizes of the mesh dims its spec names)."""
    from repro_torch.distributed import sharding as sr
    from repro_torch.train import steps
    specs = steps.state_specs(steps.full_state(state), mesh)
    sizes = sr.mesh_shape(mesh)
    bad, n = [], 0

    def check(t, spec, _path):
        nonlocal n
        if t.ndim == 0:
            return t
        n += 1
        want = list(t.shape)
        for d, axes in enumerate(spec):
            for a in (() if axes is None else
                      (axes,) if isinstance(axes, str) else axes):
                want[d] //= sizes[a]
        if list(t.to_local().shape) != want:
            bad.append((tuple(t.shape), spec))
        return t
    steps._zip_specs(check, state, specs)
    return n, bad


def _moe_cases(mesh):
    """moe_ep against moe_local on both paths, on this rank's data shard."""
    from repro_torch.configs import base as cb
    from repro_torch.models import moe
    from repro_torch.models.common import KeyGen
    cfg = cb.get_reduced_config("dbrx_132b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=4.0))
    p = moe.init_moe(KeyGen(9)(), cfg, device="cpu")
    d = mesh.get_local_rank("data")
    e_loc = cfg.moe.n_experts // mesh.size(1)
    lo = mesh.get_local_rank("model") * e_loc
    own = dict(p, **{k: p[k][lo:lo + e_loc]
                     for k in ("wi_gate", "wi_up", "wo")})
    out = {}
    for name, shape in (("a2a", (4, 16)), ("psum", (2, 1))):
        g = torch.Generator().manual_seed(10)
        x = torch.randn(shape + (cfg.d_model,), generator=g)
        rows = shape[0] // 2
        xl = x[d * rows:(d + 1) * rows]
        if name == "a2a":
            y_loc, _ = moe.moe_local(p, x, cfg)
        else:
            y_loc, _ = moe.moe_local(p, x, cfg, dropless=True)
        want = y_loc[d * rows:(d + 1) * rows]
        y_ep, aux = moe.moe_ep(p, xl, cfg, mesh, data_axes=("data",))
        out[name] = float((y_ep - want).abs().max())
        # the rank's own experts only, as the sharded train step passes
        y_own, _ = moe.moe_ep(own, xl, cfg, mesh, data_axes=("data",))
        out[f"{name}_own_experts"] = float((y_own - want).abs().max())
    return out


def _gather_counts(cfg, opt, mesh):
    """{remat: (layer-parameter gathers in one sharded step, the stacks'
    layer parameters)}: the layers gather their shards on use, and again
    in the remat recompute."""
    from repro_torch.train import steps
    out = {}
    forward = steps._GatherOnUse.forward
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        state = steps.init_train_state(c, opt, 0, device="cpu")
        _, slots = steps._grad_slots(steps.model_of(c, state["params"]))
        n = sum(steps._in_stack(path) for path, _ in slots)
        calls = []

        def counting(ctx, *args):
            calls.append(1)
            return forward(ctx, *args)
        steps._GatherOnUse.forward = staticmethod(counting)
        try:
            steps.make_train_step(c, opt, rt=steps.make_runtime(mesh))(
                steps.shard_state(state, mesh), _batch(c))
        finally:
            steps._GatherOnUse.forward = staticmethod(forward)
        out[remat] = (len(calls), n)
    return out


def _rank_body(out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import checkpoint as ckpt_lib
    from repro_torch.configs import base as cb
    from repro_torch.data.pipeline import lm_batch
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.train import steps
    from repro_torch.train.loop import LoopConfig, elastic_resume, train

    rank = dist.get_rank()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    res = {}
    smollm = cb.get_reduced_config("smollm_135m")
    for kind in ("adamw", "adafactor"):
        opt = OptConfig(kind=kind, lr=1e-3, warmup_steps=1, total_steps=10)
        res[f"smollm_{kind}"] = _compare(smollm, opt, mesh)
    opt = OptConfig(kind="adamw", lr=1e-3, warmup_steps=1, total_steps=10)
    for arch in FAMILIES:
        cfg = _nodrop(cb.get_reduced_config(arch), aux_weight=0.0)
        res[arch] = _compare(cfg.replace(remat=True), opt, mesh,
                             microbatches=2)
    # dbrx with its router loss: the sharded loss is the reference's
    # (the shards' mean), not the single-device one
    cfg = _nodrop(cb.get_reduced_config("dbrx_132b")).replace(remat=True)
    res["dbrx_aux"] = _compare(cfg, opt, mesh)
    res["moe"] = _moe_cases(mesh)

    res["gathers"] = _gather_counts(smollm, opt, mesh)
    # Adafactor on the shards, experts included (sharded over both dims)
    ada = OptConfig(kind="adafactor", lr=1e-3, warmup_steps=1,
                    total_steps=10)
    for arch in ADAFACTOR_MOE:
        cfg = _nodrop(cb.get_reduced_config(arch), aux_weight=0.0)
        res[f"adafactor_{arch}"] = _compare(cfg.replace(remat=True), ada,
                                            mesh)

    # the loop on the mesh, with and without a failure
    dirs = [os.path.join(out_dir, f"loop{i}") for i in range(2)]
    finals = []
    for i, inject in enumerate((None, 3)):
        st = steps.shard_state(steps.init_train_state(smollm, opt, 0,
                                                      device="cpu"), mesh)
        step = steps.make_train_step(smollm, opt,
                                     rt=steps.make_runtime(mesh))
        loop_cfg = LoopConfig(total_steps=6, ckpt_every=2, ckpt_dir=dirs[i],
                              log_every=100)
        st, hist = train(st, step, lambda s: lm_batch(
            0, s, batch=8, seq=32, vocab=smollm.vocab, device="cpu"),
            loop_cfg, inject_failure_at=inject)
        finals.append(steps.full_state(st))
    res["loop_equal"] = _max_diff(finals[0], finals[1]) == 0.0

    # the CLI on the mesh
    from repro_torch.launch.train import main as train_main
    hist = train_main(["--arch", "smollm-135m", "--reduced", "--steps", "4",
                       "--batch", "8", "--seq", "32", "--mesh", "test",
                       "--device", "cpu",
                       "--ckpt-dir", os.path.join(out_dir, "cli"),
                       "--ckpt-every", "2", "--log-level", "WARNING"])
    res["cli_losses"] = [h["loss"] for h in hist]

    # elastic: the loop's step-6 checkpoint restored onto ranks 0 and 1
    template = steps.init_train_state(smollm, opt, 1, device="cpu")
    saved, _ = ckpt_lib.restore(dirs[0], template)
    state, step, emesh = elastic_resume(template, dirs[0], [0, 1],
                                        prefer_model=2)
    res["elastic_step"] = step
    res["elastic_member"] = state is not None
    if state is not None:
        res["elastic_mesh"] = tuple(emesh.mesh.shape)
        res["elastic_equal"] = _max_diff(steps.full_state(state), saved) \
            == 0.0
        res["elastic_shards"] = _shard_report(state, emesh)
        estep = steps.make_train_step(smollm, opt,
                                      rt=steps.make_runtime(emesh))
        batch = _batch(smollm)
        sd, md = estep(state, batch)
        sref, mref = steps.make_train_step(smollm, opt)(saved, batch)
        res["elastic_step_loss"] = abs(float(md["loss"])
                                       - float(mref["loss"]))
        res["elastic_step_params"] = _max_diff(
            steps.full_state(sd)["params"], sref["params"])
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train_dist"))
    rdist.spawn(_rank_body, 4, out, backend="gloo", device="cpu")
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(4)]


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_train_step_sharded_matches_single(ranks, kind):
    for res in ranks:
        r = res[f"smollm_{kind}"]
        assert abs(r["loss"] - r["loss_ref"]) < LOSS_TOL
        assert r["param_diff"] < PARAM_TOL
        assert abs(r["grad_norm"] - r["grad_norm_ref"]) \
            <= LOSS_TOL * r["grad_norm_ref"], r
        assert r["finite"]


@pytest.mark.parametrize("arch", ADAFACTOR_MOE)
def test_adafactor_on_the_shards_matches_single(ranks, arch):
    """Adafactor updates each rank's shards (its row and column
    statistics summed over the shards): the step, its state and the
    shards' shapes are those of the single-device step."""
    for res in ranks:
        r = res[f"adafactor_{arch}"]
        assert r["finite"]
        assert abs(r["loss"] - r["loss_ref"]) < LOSS_TOL, r
        assert r["param_diff"] < PARAM_TOL, r
        assert r["opt_diff"] <= OPT_TOL * r["opt_top"], r
        assert abs(r["grad_norm"] - r["grad_norm_ref"]) \
            <= LOSS_TOL * r["grad_norm_ref"], r
        assert r["shards"][1] == []


@pytest.mark.parametrize("remat", [False, True])
def test_layers_gather_their_shards_on_use(ranks, remat):
    """Each layer parameter is gathered where its layer runs: once a
    step, twice under remat (the recompute gathers it again, so no
    gathered layer outlives its group)."""
    for res in ranks:
        calls, n = res["gathers"][remat]
        assert n > 0 and calls == (2 if remat else 1) * n


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_each_rank_holds_the_rules_shard(ranks, kind):
    for res in ranks:
        n, bad = res[f"smollm_{kind}"]["shards"]
        assert n > 0 and bad == []


@pytest.mark.parametrize("arch", FAMILIES)
def test_families_with_microbatches_and_remat(ranks, arch):
    for res in ranks:
        r = res[arch]
        assert r["finite"]
        assert abs(r["loss"] - r["loss_ref"]) < LOSS_TOL, r
        assert r["param_diff"] < PARAM_TOL, r
        # Adam's first step is blind to a gradient's scale: hold its norm
        assert abs(r["grad_norm"] - r["grad_norm_ref"]) \
            <= LOSS_TOL * r["grad_norm_ref"], r
        assert r["shards"][1] == []


def test_dbrx_router_loss_is_the_shards_mean(ranks):
    """With the load-balance term on, moe_ep's loss is nll + the mean of
    the token shards' router losses (the reference's ``pmean``); the nll
    is the single-device one."""
    r = [res["dbrx_aux"] for res in ranks]
    assert all(x["finite"] for x in r)
    assert abs(r[0]["loss"] - (r[0]["nll"] + r[0]["aux"])) < 1e-6
    for x in r:
        assert x["loss"] == r[0]["loss"]              # replicated metrics
    assert abs(r[0]["nll"] - r[0]["nll_ref"]) < LOSS_TOL


@pytest.mark.parametrize("path", ["a2a", "psum", "a2a_own_experts",
                                  "psum_own_experts"])
def test_moe_ep_matches_local(ranks, path):
    for res in ranks:
        assert res["moe"][path] < 2e-5


def test_loop_on_the_mesh_resumes_bitexact(ranks):
    for res in ranks:
        assert res["loop_equal"]


def test_cli_on_a_test_mesh(ranks):
    losses = [res["cli_losses"] for res in ranks]
    assert all(len(x) == 4 for x in losses)
    assert all(x == losses[0] for x in losses)
    assert np.isfinite(losses[0]).all()


def test_elastic_resume_onto_two_of_four_ranks(ranks):
    for r, res in enumerate(ranks):
        assert res["elastic_step"] == 6
        assert res["elastic_member"] == (r < 2)
    for res in ranks[:2]:
        assert res["elastic_mesh"] == (1, 2)
        assert res["elastic_equal"]
        n, bad = res["elastic_shards"]
        assert n > 0 and bad == []
        assert res["elastic_step_loss"] < LOSS_TOL
        assert res["elastic_step_params"] < PARAM_TOL
