"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's.

For every leaf of every reduced architecture, the port's spec of each
per-layer parameter (path with the group index, no scan dim) equals the
reference's ``param_pspec`` of the stacked leaf without its leading None,
on the reference's ``FakeMesh`` {"pod": 2, "data": 16, "model": 16} and
on a (2, 2) ("data", "model") mesh; the train state's specs equal the
reference's ``state_shardings``; ``batch_pspec`` and ``cache_shardings``
agree; tests/test_misc_system.py's two cases hold; and specs turn into
DTensor placements.  The reference's ``NamedSharding`` is replaced by the
bare spec in its modules' namespaces (a fake mesh cannot build one).
"""

import dataclasses

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import base as jcb
from repro.distributed import sharding as jsr
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.configs import base as cb
from repro_torch.distributed import sharding as sr
from repro_torch.models import lm as tlm
from repro_torch.optim.optimizers import OptConfig
from repro_torch.train import steps


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"pod_data_model": {"pod": 2, "data": 16, "model": 16},
          "data2_model2": {"data": 2, "model": 2},
          "data4": {"data": 4}}         # no "model": batch specs only


@pytest.fixture(autouse=True)
def bare_specs(monkeypatch):
    """The reference's shardings as bare PartitionSpecs."""
    monkeypatch.setattr(jsr, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jsteps, "NamedSharding", lambda mesh, spec: spec)


def _ref_specs(arch, mesh):
    """{"/"-joined reference path: (spec tuple, stacked?)}"""
    cfg = jcb.get_reduced_config(arch)
    spec = jax.eval_shape(lambda: jlm.init_params(cfg, jax.random.PRNGKey(0)))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(spec)[0]:
        key = jsr._path_str(path)
        out[key] = tuple(jsr.param_pspec(path, leaf, mesh))
    return out


def _port_leaves(arch):
    """(per-layer path, per-layer shape, reference path, group or None)"""
    cfg = cb.get_reduced_config(arch)
    tree = tlm.init_params(cfg, 0, device=torch.device("meta"))
    out = []

    def walk(t, path, ref, g):
        if t is None:
            return
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,), ref + (k,), g)
        elif isinstance(t, list):
            stacked = len(path) == 3 and path[1] == "groups"
            for i, v in enumerate(t):
                walk(v, path + (str(i),), ref if stacked else ref + (str(i),),
                     i if stacked else g)
        else:
            out.append(("/".join(path), tuple(t.shape), "/".join(ref), g))
    walk(tree, (), (), None)
    return out


@pytest.mark.parametrize("mesh", ["pod_data_model", "data2_model2"])
@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_param_specs_match_the_reference(arch, mesh):
    fake = FakeMesh(MESHES[mesh])
    ref = _ref_specs(arch, fake)
    seen = set()
    for path, shape, ref_path, g in _port_leaves(arch):
        want = ref[ref_path]
        if g is not None:
            assert want[0] is None, ref_path        # the scan dim
            want = want[1:]
        got = sr.param_pspec(path, shape, fake)
        assert got == want, (path, got, want)
        seen.add(ref_path)
    assert seen == set(ref)


@pytest.mark.parametrize("mesh", ["pod_data_model", "data2_model2"])
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["smollm_135m", "dbrx_132b",
                                  "recurrentgemma_9b"])
def test_state_specs_match_state_shardings(arch, kind, mesh):
    fake = FakeMesh(MESHES[mesh])
    jcfg = jcb.get_reduced_config(arch)
    jspec = jsteps.train_state_specs(jcfg, jopt.OptConfig(kind=kind))
    want = jsteps.state_shardings(jspec, fake)
    got = steps.state_specs(
        steps.train_state_specs(cb.get_reduced_config(arch),
                                OptConfig(kind=kind)), fake)
    assert got["step"] == () and tuple(want["step"]) == ()
    for part in ("params", "opt"):
        flat = {jsr._path_str(p): tuple(s) for p, s in
                jax.tree_util.tree_flatten_with_path(
                    want[part], is_leaf=lambda x: isinstance(x, P))[0]}
        mine = {}

        def walk(t, path):
            if t is None:
                return
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, path + (k,))
            elif isinstance(t, list):
                for i, v in enumerate(t):
                    walk(v, path + (str(i),))
            else:
                mine["/".join(path)] = t
        walk(got[part], ())
        assert mine == flat, part


def test_param_pspec_templates():
    """tests/test_misc_system.py's two cases."""
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert sr.param_pspec(("embed", "tok"), (49152, 576), mesh) == \
        ("model", ("pod", "data"))
    # non-divisible dims fall back to replication
    assert sr.param_pspec(("embed", "tok"), (7, 576), mesh)[0] is None


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("batch", [None, 1, 2, 4, 8, 64, 96])
def test_batch_pspec_matches_the_reference(mesh, ndim, batch):
    fake = FakeMesh(MESHES[mesh])
    want = tuple(jsr.batch_pspec(fake, ndim, batch_dim_size=batch))
    assert sr.batch_pspec(fake, ndim, batch_dim_size=batch) == want


@pytest.mark.parametrize("mesh", ["pod_data_model", "data2_model2"])
@pytest.mark.parametrize("arch", ["qwen2_72b", "recurrentgemma_9b",
                                  "xlstm_125m", "whisper_base",
                                  "llama32_vision_90b"])
def test_cache_shardings_match_the_reference(arch, mesh):
    fake = FakeMesh(MESHES[mesh])
    B = 8
    shape = jcb.ShapeConfig("t", 64, B, "decode")
    jspec = jlm.input_specs(jcb.get_reduced_config(arch), shape)["caches"]
    want = jsr.cache_shardings(jspec, fake, B)
    cfg = cb.get_reduced_config(arch)
    got = sr.cache_shardings(tlm.input_specs(cfg, shape)["caches"], fake, B)
    period = len(cfg.layer_pattern)
    n_groups = cfg.n_layers // period
    for layer, specs in enumerate(got):
        if layer < n_groups * period:
            ref = want["groups"][f"p{layer % period}"]
            strip = True
        else:
            ref = want["tail"][layer - n_groups * period]
            strip = False

        def cmp(mine, theirs, path):
            if isinstance(mine, dict):
                assert set(mine) == set(theirs), path
                for k in mine:
                    cmp(mine[k], theirs[k], f"{path}/{k}")
            else:
                t = tuple(theirs)
                assert mine == (t[1:] if strip else t), (path, mine, t)
        cmp(specs, ref, str(layer))


def test_specs_become_placements():
    from torch.distributed.tensor import Replicate, Shard

    @dataclasses.dataclass
    class Named:
        mesh_dim_names: tuple

    m3 = Named(("pod", "data", "model"))
    assert sr.to_placements(("model", ("pod", "data")), m3) == [
        Shard(1), Shard(1), Shard(0)]
    assert sr.to_placements((None, None), m3) == [Replicate()] * 3
    assert sr.to_placements(("data", None, "model"), Named(("data",
                                                            "model"))) == [
        Shard(0), Shard(2)]


@pytest.mark.parametrize("mesh", ["pod_data_model", "data2_model2"])
@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("kind,shape", [
    ("act_btd", (32, 64, 576)), ("act_btd", (3, 7, 576)),
    ("act_btd", (64, 4096, 8192)), ("act_btv", (32, 64, 49152)),
    ("act_btv", (1, 5, 49153)), ("act_bsh", (32, 64, 576))])
def test_constraint_specs_match_the_reference(mesh, seq_parallel, kind,
                                              shape, monkeypatch):
    """The port's constraint specs are those the reference's hook
    constrains an activation of ``shape`` to (the constraint captured)."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    fake = FakeMesh(MESHES[mesh])
    x = dataclasses.make_dataclass("Shaped", ["shape"])(shape)
    want = jsr.make_constraint_fn(fake, seq_parallel=seq_parallel)(x, kind)
    got = sr.make_constraint_fn(fake, seq_parallel=seq_parallel)(shape, kind)
    assert got == (None if want is x else tuple(want))
