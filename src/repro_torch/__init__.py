"""MPI-FAUN alternating-updating NMF in PyTorch, for an NVIDIA H100.

The counterpart of the JAX package ``repro``: the same module layout and
names, plain functions on tensors, an explicit ``device=`` and explicit
``torch.Generator``s.  The hand-written TPU kernels of ``repro.kernels``
become hand-written CUDA kernels (``repro_torch.kernels.csrc``), built with
``nvcc`` on first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; a
CUDA request on a machine without a card raises, it never carries on on the
CPU.  On the CPU every kernel wrapper runs its plain PyTorch version
(``repro_torch.kernels.ref``), which is what the parity tests hold against
the JAX package.

This package imports ``torch`` only — never ``jax``, and nothing of
``repro``.
"""

__all__ = ["backends", "checkpoint", "core", "data", "kernels", "obs",
           "serve", "util"]
