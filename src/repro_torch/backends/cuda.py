"""CUDA backend: the hand-written Hopper kernels of
``repro_torch.kernels`` — the counterpart of ``repro/backends/pallas.py``.

A streams once through each of ``ts_matmul`` (A·Hᵀ) and ``ts_matmul_t``
(AᵀW), and ``gram`` reduces each factor panel to its k×k Gram.  The kernels
take fp32 or bf16 inputs and accumulate and return fp32.  On CPU tensors
the wrappers run their plain PyTorch versions (``kernels/ref.py``); on CUDA
tensors they launch the kernel or raise.
"""

from __future__ import annotations

from repro_torch.backends.base import LocalOps
from repro_torch.kernels import ops as kops


class CudaOps(LocalOps):
    name = "cuda"

    def mm(self, A, B):
        return kops.ts_matmul(A, B)

    def mm_t(self, A, B):
        return kops.ts_matmul_t(A, B)

    def gram(self, X):
        return kops.gram(X)
