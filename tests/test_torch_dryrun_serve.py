"""``repro_torch.launch.dryrun``'s prefill and decode cells on a fake
world of four ranks: every reduced architecture's cells read ``ok`` on a
2 × 2 ("data", "model") mesh; the depth-variant extrapolation equals a
full-depth run; and the matmul FLOPs of reduced smollm's prefill equal the
JAX package's dry-run count on 2 forced host devices (run in a
subprocess)."""

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
    """cost(1) + (G − 1)·(cost(2) − cost(1)) equals the full-depth count:
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


_JAX_PREFILL = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
from repro.configs import base as rcb
from repro.launch import dryrun as rdry
from repro.roofline.hlo import weighted_op_costs
from repro.util.compat import make_mesh
S, B = int(sys.argv[1]), int(sys.argv[2])
rcb.SHAPES["prefill_tiny"] = rcb.ShapeConfig("prefill_tiny", S, B, "prefill")
mesh = make_mesh((2, 1), ("data", "model"))
low, _, _ = rdry.lower_cell("smollm_135m", "prefill_tiny", mesh,
                            cfg=rcb.get_reduced_config("smollm_135m"))
print("DOT_FLOPS", weighted_op_costs(low.compile().as_text())["dot_flops"])
"""


def test_prefill_flops_match_the_jax_dry_run(mesh):
    """Reduced smollm's prefill on a mesh of 2 data ranks ("model" of
    size 1: neither package's sharding rules take a mesh without it): the
    port's counted matmul FLOPs per rank against the reference's
    ``weighted_op_costs(...)["dot_flops"]``.  They agree exactly (both run
    the same products on the same local shapes, the full logits included);
    the test allows 1 %, for an XLA that counts a fused product's
    operands another way."""
    from torch.distributed.device_mesh import DeviceMesh
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    S, B = PREFILL
    out = subprocess.run([sys.executable, "-c", _JAX_PREFILL, str(S),
                          str(B)], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = float(out.stdout.split("DOT_FLOPS")[-1])
    mesh = DeviceMesh("cuda", [[0], [1]], mesh_dim_names=("data", "model"))
    rec, _, _ = dryrun.lower_cell(
        "smollm_135m", "prefill_tiny", mesh,
        cfg=cb.get_reduced_config("smollm_135m"),
        shape=cb.ShapeConfig("prefill_tiny", S, B, "prefill"))
    assert rec.dot_flops == pytest.approx(want, rel=0.01)


