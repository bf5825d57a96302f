"""``repro_torch.launch.dryrun``'s prefill and decode cells on a fake
world of eight ranks: every reduced architecture's cells read ``ok`` on a
2 × 2 × 2 ("pod", "data", "model") mesh."""

import pytest

from _dryrun_cells import check_cell, fake_mesh
from repro_torch.configs import base as cb


@pytest.fixture(scope="module")
def mesh():
    with fake_mesh("multipod") as m:
        yield m


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", cb.ARCH_IDS)
def test_reduced_serving_cell_runs_multipod(arch, kind, mesh):
    check_cell(arch, kind, "multipod", mesh)
