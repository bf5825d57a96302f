"""``repro_torch.launch.dryrun`` on a fake world of four ranks (one
process, the ``fake`` backend, fake tensors): every reduced architecture's
train cell reads ``ok`` on a 2 × 2 ("data", "model") mesh, reduced NMF
cells put the cost model's words on the wire, and ``main`` refuses a
foreign default group.  The prefill and decode cells, the depth variants
and the comparison with the JAX dry run are
tests/test_torch_dryrun_serve.py; the 2 × 2 × 2 multipod mesh
tests/test_torch_dryrun_multipod*.py."""

import os
import subprocess
import sys

import pytest

from _dryrun_cells import check_cell, fake_mesh
from repro_torch.configs import base as cb
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def mesh():
    with fake_mesh("single") as m:
        yield m


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_reduced_train_cell_runs(arch, mesh):
    check_cell(arch, "train", "single", mesh)


@pytest.mark.parametrize("algo", ["mu", "hals", "bpp"])
@pytest.mark.parametrize("pods", [1, 2])
def test_reduced_nmf_cells_put_the_model_words_on_the_wire(algo, pods,
                                                           mesh):
    """The counted bytes a rank receives equal the cost model's words × 4 B
    (plus the error byproduct's Gram and scalar, ``dryrun.error_words``)."""
    from repro_torch.core.faun import make_faun_grid
    grid = make_faun_grid(2 // pods, 2, pods=pods)
    c = dryrun.nmf_cell(grid, 256, 128, 8, algo)
    wire = c["ici"] + c["dcn"]
    assert wire == pytest.approx(c["costmodel_wire_bytes"], rel=1e-9)


def test_dry_run_refuses_a_foreign_world():
    """``main`` refuses where a default group of another backend exists
    (its own fake world would replace it)."""
    code = ("import torch.distributed as dist, tempfile, os\n"
            "f = os.path.join(tempfile.mkdtemp(), 'rdv')\n"
            "dist.init_process_group('gloo', init_method='file://' + f, "
            "rank=0, world_size=1)\n"
            "from repro_torch.launch import dryrun\n"
            "try:\n"
            "    dryrun.main(['--nmf', '--no-save'])\n"
            "except SystemExit as e:\n"
            "    print('EXIT', e)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert "EXIT the dry run makes its own fake world" in out.stdout, \
        out.stdout + out.stderr
