"""Plain PyTorch versions of the port's CUDA kernels — the counterpart of
``repro/kernels/ref.py``.

The kernel wrappers (``kernels/ops.py``) run these on CPU tensors, and
``chip_smoke.py`` holds each kernel against its version here on the card.
Inputs are upcast to fp32 first, so a bf16 input is multiplied exactly and
summed in fp32, like the kernels (and like ``preferred_element_type`` in
the reference).
"""

from __future__ import annotations

import torch


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def gram(X: torch.Tensor) -> torch.Tensor:
    """XᵀX with fp32 accumulation."""
    X = _f32(X)
    return X.T @ X


def ts_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B, B tall-skinny (n × k), fp32 accumulation."""
    return _f32(A) @ _f32(B)


def ts_matmul_t(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Aᵀ @ B through the transposed view: Aᵀ is not materialised."""
    return _f32(A).T @ _f32(B)
