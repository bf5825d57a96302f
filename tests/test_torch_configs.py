"""The port's config registry (``repro_torch.configs``) against the JAX
package's: every architecture's full and reduced config field by field,
the aliases, the shapes, which cells run, and ``input_specs`` (shapes and
dtypes of every arch × shape, decode caches included) against the
reference's ``ShapeDtypeStruct`` / ``eval_shape`` ones."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jcb
from repro.models import lm as jlm
from repro_torch.configs import base as cb
from repro_torch.models import lm


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


@pytest.mark.parametrize("arch", jcb.ARCH_IDS)
@pytest.mark.parametrize("which", ["get_config", "get_reduced_config"])
def test_configs_equal_the_reference_field_by_field(arch, which):
    ours = dataclasses.asdict(getattr(cb, which)(arch))
    ref = dataclasses.asdict(getattr(jcb, which)(arch))
    assert ours.keys() == ref.keys()
    for name in ref:
        assert ours[name] == ref[name], (arch, name, ours[name], ref[name])


def test_registry_equals_the_reference():
    assert cb.ARCH_IDS == jcb.ARCH_IDS
    assert cb.ALIASES == jcb.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in cb.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcb.SHAPES.items()}
    for name, shape in cb.SHAPES.items():
        assert shape.tokens == jcb.SHAPES[name].tokens
    for alias, mod in cb.ALIASES.items():
        assert cb.get_config(alias) == cb.get_config(mod)
        assert cb.get_config(alias).name == jcb.get_config(alias).name
    assert cb.get_config("llama4-maverick-400b-a17b").moe.n_experts == 128


def test_cell_is_runnable_equals_the_reference():
    for arch in cb.ARCH_IDS:
        for name, shape in cb.SHAPES.items():
            assert cb.cell_is_runnable(cb.get_config(arch), shape) == \
                jcb.cell_is_runnable(jcb.get_config(arch),
                                     jcb.SHAPES[name]), (arch, name)


def test_dtype_properties_are_torch_dtypes():
    for arch in cb.ARCH_IDS:
        for cfg, ref in ((cb.get_config(arch), jcb.get_config(arch)),
                         (cb.get_reduced_config(arch),
                          jcb.get_reduced_config(arch))):
            assert _dtype_name(cfg.param_dtype_torch) == \
                _dtype_name(ref.param_dtype_jnp)
            assert _dtype_name(cfg.dtype_torch) == _dtype_name(ref.dtype_jnp)
            assert cfg.is_encdec == ref.is_encdec
            assert cfg.head_dim == ref.head_dim


def _same_spec(got, want, where):
    assert got.device.type == "meta", where
    assert tuple(got.shape) == tuple(want.shape), where
    assert _dtype_name(got.dtype) == _dtype_name(want.dtype), where


@pytest.mark.parametrize("arch", jcb.ARCH_IDS)
def test_input_specs_match_the_reference(arch):
    cfg, jcfg = cb.get_config(arch), jcb.get_config(arch)
    period = len(cfg.layer_pattern)
    n_groups = cfg.n_layers // period
    for name, shape in cb.SHAPES.items():
        ours = lm.input_specs(cfg, shape)
        ref = jlm.input_specs(jcfg, jcb.SHAPES[name])
        assert ours.keys() == ref.keys(), (arch, name)
        for key in ref:
            if key != "caches":
                _same_spec(ours[key], ref[key], (arch, name, key))
                continue
            caches = ours["caches"]
            assert len(caches) == cfg.n_layers
            for layer, cache in enumerate(caches):
                g, i = divmod(layer, period)
                if g < n_groups:
                    want = jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                        s.shape[1:], s.dtype), ref["caches"]["groups"][f"p{i}"])
                else:
                    want = ref["caches"]["tail"][layer - n_groups * period]
                flat_ours = jax.tree_util.tree_leaves_with_path(cache)
                flat_ref = jax.tree_util.tree_leaves_with_path(want)
                assert [p for p, _ in flat_ours] == [p for p, _ in flat_ref]
                for (path, got), (_, exp) in zip(flat_ours, flat_ref):
                    _same_spec(got, exp, (arch, name, layer, path))
