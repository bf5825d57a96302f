"""``repro_torch.launch.dryrun`` on a fake world of eight ranks: every
reduced architecture's train cell reads ``ok`` on a 2 × 2 × 2 ("pod",
"data", "model") mesh, and its collectives over both pods are priced on
the inter-pod links.  The prefill and decode cells are
tests/test_torch_dryrun_multipod_serve.py."""

import pytest

from _dryrun_cells import check_cell, fake_mesh
from repro_torch.configs import base as cb


@pytest.fixture(scope="module")
def mesh():
    with fake_mesh("multipod") as m:
        yield m


@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_reduced_train_cell_runs_multipod(arch, mesh):
    rec = check_cell(arch, "train", "multipod", mesh)
    # the data-parallel reductions span both pods: over InfiniBand
    assert rec["collective_dcn_bytes_per_chip"] > 0
    assert rec["collective_bytes_per_chip"] \
        >= rec["collective_dcn_bytes_per_chip"]
