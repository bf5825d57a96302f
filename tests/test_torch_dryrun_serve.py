"""``repro_torch.launch.dryrun``'s prefill and decode cells on a fake
world of four ranks: every reduced architecture's cells read ``ok`` on a
2 × 2 ("data", "model") mesh; the depth-variant extrapolation equals a
full-depth run; the matmul FLOPs of reduced smollm's prefill equal the
JAX package's dry-run count on 2 forced host devices (run in a
subprocess) on a (2, 1) mesh, and on a (1, 2) mesh, where the prefill runs
tensor-parallel, come within 5 % of it; and a decode cell on (1, 2) holds
each cache at half its KV length."""

import os
import subprocess
import sys

import pytest

from _dryrun_cells import SHAPES, check_cell, fake_mesh
from repro_torch.configs import base as cb
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the prefill the JAX side lowers too: reduced smollm, 4 × 128 tokens
PREFILL = (128, 4)


@pytest.fixture(scope="module")
def mesh():
    with fake_mesh("single") as m:
        yield m


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_reduced_serving_cell_runs(arch, kind, mesh):
    check_cell(arch, kind, "single", mesh)


def test_depth_variants_extrapolate_exactly(mesh):
    """cost(2) + (G − 2)·(cost(3) − cost(2)) equals the full-depth count:
    eager PyTorch runs every layer group as the same ops."""
    cfg = cb.get_reduced_config("smollm_135m").replace(n_layers=9)
    assert dryrun.n_groups_of(cfg) == 9
    full = dryrun.cell_costs("smollm_135m", "train_tiny", mesh, cfg=cfg,
                             shape=SHAPES["train"], full_depth=True)
    extra = dryrun.cell_costs("smollm_135m", "train_tiny", mesh, cfg=cfg,
                              shape=SHAPES["train"])
    for key in ("flops_by_rate", "bytes", "ici", "counts", "wire",
                "arg_bytes", "peak_bytes"):
        assert extra[key] == full[key], key


def test_depth_variants_extrapolate_the_prefill_peak_exactly(mesh):
    """The same for a tensor-parallel prefill, whose peak the first layer
    group does not reach (no earlier layer's output is alive while it
    runs): the variants g = 2 and 3 put it on the line."""
    cfg = cb.get_reduced_config("qwen2_72b").replace(n_layers=7)
    full = dryrun.cell_costs("qwen2_72b", "prefill_tiny", mesh, cfg=cfg,
                             shape=SHAPES["prefill"], full_depth=True)
    extra = dryrun.cell_costs("qwen2_72b", "prefill_tiny", mesh, cfg=cfg,
                              shape=SHAPES["prefill"])
    for key in ("flops_by_rate", "bytes", "ici", "counts", "wire",
                "arg_bytes", "peak_bytes"):
        assert extra[key] == full[key], key


_JAX_PREFILL = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
DP, MP = int(sys.argv[3]), int(sys.argv[4])
from repro.configs import base as rcb
from repro.launch import dryrun as rdry
from repro.roofline.hlo import weighted_op_costs
from repro.util.compat import make_mesh
S, B = int(sys.argv[1]), int(sys.argv[2])
rcb.SHAPES["prefill_tiny"] = rcb.ShapeConfig("prefill_tiny", S, B, "prefill")
mesh = make_mesh((DP, MP), ("data", "model"))
low, _, _ = rdry.lower_cell("smollm_135m", "prefill_tiny", mesh,
                            cfg=rcb.get_reduced_config("smollm_135m"))
print("DOT_FLOPS", weighted_op_costs(low.compile().as_text())["dot_flops"])
"""


def _jax_prefill_dot_flops(dp: int, mp: int) -> float:
    """The JAX dry run's ``dot_flops`` of reduced smollm's prefill on a
    (dp, mp) mesh of forced host devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    S, B = PREFILL
    out = subprocess.run([sys.executable, "-c", _JAX_PREFILL, str(S),
                          str(B), str(dp), str(mp)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return float(out.stdout.split("DOT_FLOPS")[-1])


def test_prefill_flops_match_the_jax_dry_run(mesh):
    """Reduced smollm's prefill on a mesh of 2 data ranks ("model" of
    size 1: neither package's sharding rules take a mesh without it): the
    port's counted matmul FLOPs per rank against the reference's
    ``weighted_op_costs(...)["dot_flops"]``.  They agree exactly (both run
    the same products on the same local shapes, the full logits included);
    the test allows 1 %, for an XLA that counts a fused product's
    operands another way."""
    from torch.distributed.device_mesh import DeviceMesh
    want = _jax_prefill_dot_flops(2, 1)
    S, B = PREFILL
    mesh = DeviceMesh("cuda", [[0], [1]], mesh_dim_names=("data", "model"))
    rec, _, _ = dryrun.lower_cell(
        "smollm_135m", "prefill_tiny", mesh,
        cfg=cb.get_reduced_config("smollm_135m"),
        shape=cb.ShapeConfig("prefill_tiny", S, B, "prefill"))
    assert rec.dot_flops == pytest.approx(want, rel=0.01)




def test_tensor_parallel_prefill_flops_match_the_jax_dry_run(mesh):
    """Reduced smollm's prefill on a (1, 2) mesh, "model" = 2, where its 6
    heads, 2 KV heads, 192 FFN columns and 256-token vocabulary all divide:
    each rank computes its heads, columns and vocabulary rows, and the
    port's counted matmul FLOPs per rank come within 5 % of the reference's
    ``dot_flops`` on the same mesh (GSPMD's sharded program)."""
    from torch.distributed.device_mesh import DeviceMesh
    want = _jax_prefill_dot_flops(1, 2)
    S, B = PREFILL
    tp_mesh = DeviceMesh("cuda", [[0, 1]], mesh_dim_names=("data", "model"))
    rec, _, _ = dryrun.lower_cell(
        "smollm_135m", "prefill_tiny", tp_mesh,
        cfg=cb.get_reduced_config("smollm_135m"),
        shape=cb.ShapeConfig("prefill_tiny", S, B, "prefill"))
    assert rec.dot_flops == pytest.approx(want, rel=0.05)
    whole = DeviceMesh("cuda", [[0], [1]], mesh_dim_names=("data", "model"))
    full, _, _ = dryrun.lower_cell(
        "smollm_135m", "prefill_tiny", whole,
        cfg=cb.get_reduced_config("smollm_135m"),
        shape=cb.ShapeConfig("prefill_tiny", S, 2 * B, "prefill"))
    # half the rows' work on two data ranks: the same as one model rank's
    assert rec.dot_flops == pytest.approx(full.dot_flops / 2, rel=0.05)


def test_decode_caches_hold_half_their_kv_length_on_two_model_ranks(
        mesh, monkeypatch):
    """A reduced decode cell on (1, 2): ``local_caches`` gives each rank
    half of every attention cache's KV length, and the record's inputs
    count those half caches."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.models import lm
    from repro_torch.roofline import counts
    from repro_torch.train import steps
    tp_mesh = DeviceMesh("cuda", [[0, 1]], mesh_dim_names=("data", "model"))
    cfg = cb.get_reduced_config("smollm_135m")
    shape = SHAPES["decode"]
    seen = []
    local_caches = steps.local_caches
    monkeypatch.setattr(steps, "local_caches", lambda *a, **k: seen.append(
        local_caches(*a, **k)) or seen[-1])
    rec, _, _ = dryrun.lower_cell("smollm_135m", shape.name, tp_mesh,
                                  cfg=cfg, shape=shape)
    whole = lm.input_specs(cfg, shape)["caches"]
    assert len(seen) == 1 and len(seen[0]) == len(whole) == cfg.n_layers
    for got, want in zip(seen[0], whole):
        for name in ("k", "v"):
            (b, n), (wb, wn) = (got["self"][name].shape[:2],
                                want["self"][name].shape[:2])
            assert (b, 2 * n) == (wb, wn)
    held = counts.tensor_bytes(seen[0])
    assert held * 2 == counts.tensor_bytes(whole)
    assert rec.arg_bytes > held
