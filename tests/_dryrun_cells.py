"""Shared pieces of the port's dry-run tests (tests/test_torch_dryrun*.py):
tiny shapes of each step kind, a fake world with its mesh, and one cell
run and checked."""

import contextlib

import torch.distributed as dist

from repro_torch.configs import base as cb
from repro_torch.launch import dryrun

SHAPES = {"train": cb.ShapeConfig("train_tiny", 32, 4, "train"),
          "prefill": cb.ShapeConfig("prefill_tiny", 32, 4, "prefill"),
          "decode": cb.ShapeConfig("decode_tiny", 32, 4, "decode")}
MESHES = {"single": ((2, 2), ("data", "model")),
          "multipod": ((2, 2, 2), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_mesh(kind: str):
    """A fake world of the mesh's size, this process rank 0, and the mesh
    (of fake cards); the world is destroyed on exit.  There must be no
    default process group before."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, names = MESHES[kind]
    n = 1
    for s in shape:
        n *= s
    assert not dist.is_initialized(), "a default process group exists"
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield init_device_mesh("cuda", shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def check_cell(arch: str, kind: str, mesh_kind: str, mesh) -> dict:
    """Run one reduced cell on ``mesh`` and hold its record's shape."""
    rec = dryrun.run_cell(arch, SHAPES[kind].name, mesh_kind, save=False,
                          verbose=False, cfg=cb.get_reduced_config(arch),
                          shape=SHAPES[kind], mesh=mesh)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_chips"] == mesh.size()
    assert rec["flops_per_chip"] > 0 and rec["bytes_accessed_per_chip"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    roof = rec["roofline"]
    assert roof["step_lower_bound_s"] == max(
        roof["compute_s"], roof["memory_s"], roof["collective_s"])
    if kind == "train":        # ZeRO-3: gathers on use, reduce-scatters
        assert rec["collectives"].get("all-gather", 0) > 0
    return rec
