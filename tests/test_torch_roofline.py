"""``repro_torch.roofline.hw`` and ``roofline.report`` against the JAX
package's: the same roofline for the same inputs on a chip built from the
reference's V5E fields, the H100 entry's published figures, and the
report's parameter counts, MODEL_FLOPS, runnable cells and depth variants
equal to the reference's for every architecture and shape."""

import dataclasses
import os

import pytest

from repro.configs import base as rcb
from repro.roofline import hw as rhw
from repro.roofline import report as rrep
from repro_torch.configs import base as cb
from repro_torch.launch import dryrun
from repro_torch.roofline import hw, report


def _reference_dryrun():
    """The JAX package's dryrun module.  Importing it sets XLA_FLAGS to
    force 512 host devices (its first line); the variable is put back at
    once, before JAX reads it, so this process keeps its one device."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as rdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return rdry


def _v5e_as_port_chip():
    fields = {f.name: getattr(rhw.V5E, f.name)
              for f in dataclasses.fields(rhw.Chip)}
    return hw.Chip(**fields)


@pytest.mark.parametrize("inputs", [(3e12, 4e9, 2e8, 0.0),
                                    (1e10, 8e11, 1e9, 5e7),
                                    (0.0, 0.0, 7e8, 0.0)])
def test_roofline_times_match_the_reference(inputs):
    flops, hbm, ici, dcn = inputs
    want = rhw.roofline_times(flops, hbm, ici, chip=rhw.V5E, dcn_bytes=dcn)
    got = hw.roofline_times(flops, hbm, ici, chip=_v5e_as_port_chip(),
                            dcn_bytes=dcn)
    assert got == want


def test_h100_entry():
    h = hw.H100
    assert h.peak_bf16_flops == 989.4e12
    assert h.peak_tf32_flops == 494.7e12
    assert h.peak_fp32_flops == 66.9e12
    assert h.hbm_bytes == 80e9 and h.hbm_bw == 3.35e12
    assert h.ici_bw_total == 450e9            # 18 NVLink 4 links × 25 GB/s
    assert h.dcn_bw_per_chip == 50e9          # InfiniBand NDR, per card
    assert h.rate("tf32x3") == h.peak_tf32_flops / 3


def test_flops_by_rate_use_each_rate():
    h = hw.H100
    got = hw.roofline_times({"float32": 66.9e12, "bfloat16": 989.4e12},
                            0.0, 0.0)
    assert got["compute_s"] == pytest.approx(2.0)
    assert hw.compute_seconds(989.4e12) == pytest.approx(1.0)
    assert h.rate("float32") < h.rate("tf32x3") < h.rate("bfloat16")


@pytest.fixture(scope="module")
def counted():
    """Each side's parameter counts, once per architecture."""
    return {a: (rrep.param_counts(rcb.get_config(a)),
                report.param_counts(cb.get_config(a))) for a in cb.ARCH_IDS}


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_param_counts_and_model_flops_match(arch, counted, monkeypatch):
    want, got = counted[arch]
    assert got == want
    monkeypatch.setattr(rrep, "param_counts", lambda cfg: want)
    monkeypatch.setattr(report, "param_counts", lambda cfg: got)
    for name in cb.SHAPES:
        assert report.model_flops(cb.get_config(arch), cb.SHAPES[name]) \
            == rrep.model_flops(rcb.get_config(arch), rcb.SHAPES[name])


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_cells_and_depth_variants_match(arch):
    rdry = _reference_dryrun()
    cfg, rcfg = cb.get_config(arch), rcb.get_config(arch)
    for name in cb.SHAPES:
        assert cb.cell_is_runnable(cfg, cb.SHAPES[name]) \
            == rcb.cell_is_runnable(rcfg, rcb.SHAPES[name])
    assert dryrun.n_groups_of(cfg) == rdry.n_groups_of(rcfg)
    for g in (0, 1, 2):
        got, want = dryrun.depth_variant(cfg, g), rdry.depth_variant(rcfg, g)
        assert (got.n_layers, got.encoder_layers) \
            == (want.n_layers, want.encoder_layers)
