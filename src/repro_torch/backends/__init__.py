"""Local-compute backends for the AU-NMF engine (see base.py for the
``LocalOps`` contract and registry).  Importing this package registers the
built-ins: ``dense`` (torch.matmul), ``cuda`` (the hand-written dense
kernels) and ``sparse`` (block-local COO SpMM)."""

from repro_torch.backends.base import (BackendSpec, LocalOps,
                                       available_backends, get_backend,
                                       infer_backend, register_backend)
from repro_torch.backends.cuda import CudaOps
from repro_torch.backends.dense import DenseOps
from repro_torch.backends.sparse import SparseOps

register_backend("dense", DenseOps)
register_backend("cuda", CudaOps)
register_backend("sparse", SparseOps)

__all__ = [
    "BackendSpec", "LocalOps", "CudaOps", "DenseOps", "SparseOps",
    "available_backends", "get_backend", "infer_backend", "register_backend",
]
