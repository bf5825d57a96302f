"""numpy <-> torch conversion, and carrying factors and sparse storage
between the packages.

The JAX package and the port meet only through numpy arrays: a JAX
``NMFResult``'s ``W``/``H`` (``np.asarray(res.W)``) come in through
``factors_from_numpy`` and a port result goes out through
``result_to_numpy``; a JAX ``BlockCOO``'s leaves come in through
``blockcoo_from_numpy`` and go back through ``blockcoo_to_numpy``.  numpy
has no bfloat16, so bf16 tensors leave as float32 (exact: every bf16 value
is an fp32 value).
"""

from __future__ import annotations

import numpy as np
import torch


def to_torch(x, *, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A tensor on ``device`` from a numpy array (bfloat16 ones included),
    a tensor or a scalar."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":   # ml_dtypes' bf16, which torch lacks
        arr = arr.astype(np.float32)
        dtype = dtype or torch.bfloat16
    if not arr.flags.writeable:        # e.g. a view of a JAX array's buffer
        arr = arr.copy()
    return torch.as_tensor(arr, device=device, dtype=dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def factors_from_numpy(W, H, *, device, dtype: torch.dtype = torch.float32
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(W (m, k), H (k, n)) as contiguous tensors on ``device`` — what
    ``NMFSolver.fit(W0=, H0=)`` and ``fit(init=)`` take."""
    return (to_torch(W, device=device, dtype=dtype).contiguous(),
            to_torch(H, device=device, dtype=dtype).contiguous())


def result_to_numpy(res) -> tuple[np.ndarray, np.ndarray]:
    """(W, H) of a port ``NMFResult`` as numpy arrays — usable as the JAX
    package's ``fit(init=(W, H))`` or ``fit(W0=W, H0=H)``."""
    return to_numpy(res.W), to_numpy(res.H)


def blockcoo_from_numpy(blk, *, device="cpu"):
    """The port's ``BlockCOO`` from a JAX package ``BlockCOO`` (or any
    object with its fields): each leaf through ``np.asarray``, the sort
    metadata and ``align`` included, so a layout sorted by one package runs
    in the other."""
    from repro_torch.core.blocksparse import LEAVES, BlockCOO
    leaves = {f: None if getattr(blk, f) is None
              else to_torch(getattr(blk, f), device=device) for f in LEAVES}
    return BlockCOO(shape=tuple(blk.shape), block_shape=tuple(blk.block_shape),
                    nnz=int(blk.nnz), align=int(blk.align), **leaves)


def blockcoo_to_numpy(blk) -> dict:
    """The fields of a port ``BlockCOO`` as numpy arrays (None where a
    sort leaf is absent) plus its shapes, nnz and align: the keyword
    arguments of the JAX package's ``BlockCOO`` once each array is wrapped
    in ``jnp.asarray`` (bf16 values come out as float32)."""
    from repro_torch.core.blocksparse import LEAVES
    out = {f: None if getattr(blk, f) is None else to_numpy(getattr(blk, f))
           for f in LEAVES}
    out.update(shape=tuple(blk.shape), block_shape=tuple(blk.block_shape),
               nnz=int(blk.nnz), align=int(blk.align))
    return out
