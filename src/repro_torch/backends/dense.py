"""Dense backend: plain ``torch.matmul`` with fp32 results — the
counterpart of the XLA dots of ``repro/backends/dense.py``.

``mm_t`` multiplies by the transposed *view* of A, which cuBLAS and the CPU
BLAS read in place, so Aᵀ is never materialised.  Low-precision inputs are
upcast to fp32 first (the counterpart of ``preferred_element_type``); that
copies A, so this backend is for fp32 data at full size.
"""

from __future__ import annotations

from repro_torch.backends.base import LocalOps, _f32


class DenseOps(LocalOps):
    name = "dense"

    def mm(self, A, B):
        return _f32(A) @ _f32(B)

    def mm_t(self, A, B):
        return _f32(A).T @ _f32(B)
