"""Meshes over the ``torch.distributed`` world.  Counterpart of
``repro/launch/mesh.py``.

Functions, not module-level constants: importing this module never
touches the process group.  Each needs an initialised default group
(``torchrun`` and ``util.dist.init_from_env``, or ``util.dist.spawn``)
and lays its mesh over every rank of it, in rank order: on the cards of
an NCCL group, on the CPU for gloo.
"""

from __future__ import annotations

import torch.distributed as dist


def _device_type() -> str:
    """The device the group's backend works on: NCCL → cuda, gloo →
    cpu; the dry run's ``fake`` world stands for cards (cuda)."""
    backend = dist.get_backend()
    if backend in ("nccl", "fake"):
        return "cuda"
    if backend == "gloo":
        return "cpu"
    raise ValueError(f"no mesh over a {backend} process group")


def _mesh(shape, axes):
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    need = 1
    for s in shape:
        need *= s
    if world != need:
        raise ValueError(
            f"the {'×'.join(map(str, shape))} {axes} mesh needs {need} "
            f"ranks; the process group has {world}")
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16×16 ("data", "model"), or 2×16×16 ("pod", "data", "model"): 256
    or 512 ranks, one card each."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_test_mesh(n: int | None = None, axes=("data", "model"),
                   shape=None):
    """Small mesh over the ranks of the group (tests/examples): (n/2, 2)
    where n is even and above 1, else (n, 1)."""
    if not dist.is_initialized():
        raise RuntimeError("make_test_mesh needs a process group: run under "
                           "torchrun or util.dist.spawn")
    n = n or dist.get_world_size()
    if shape is None:
        shape = (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)
    return _mesh(shape, axes)


def make_faun_production_grid(*, multi_pod: bool = False):
    """The same ranks arranged as the paper's pr×pc processor grid for the
    NMF workloads (``core.faun.make_faun_grid``; multi-pod: pods = 2)."""
    from repro_torch.core.faun import make_faun_grid
    world = dist.get_world_size()
    need = 512 if multi_pod else 256
    if world != need:
        raise ValueError(f"the production grid needs {need} ranks; the "
                         f"process group has {world}")
    return make_faun_grid(16, 16, pods=2 if multi_pod else 1)
