"""Local-compute backends for the AU-NMF engine (see base.py for the
``LocalOps`` contract and registry).  Importing this package registers the
built-ins: ``dense`` (torch.matmul) and ``cuda`` (the hand-written
kernels)."""

from repro_torch.backends.base import (BackendSpec, LocalOps,
                                       available_backends, get_backend,
                                       infer_backend, register_backend)
from repro_torch.backends.cuda import CudaOps
from repro_torch.backends.dense import DenseOps

register_backend("dense", DenseOps)
register_backend("cuda", CudaOps)

__all__ = [
    "BackendSpec", "LocalOps", "CudaOps", "DenseOps",
    "available_backends", "get_backend", "infer_backend", "register_backend",
]
