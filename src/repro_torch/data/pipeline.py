"""Synthetic NMF data — counterpart of ``repro/data/pipeline.py``
(``lowrank_matrix`` and ``erdos_renyi_bcoo``; the other generators are not
ported yet).

torch's generators do not reproduce ``jax.random``'s streams, so the same
seed gives a different matrix than the reference: parity is distributional,
and the parity tests feed both packages the same numpy arrays instead.
"""

from __future__ import annotations

import torch

#: elements per chunk while building A (a 256 MiB fp32 temporary)
_CHUNK_ELEMS = 1 << 26


def lowrank_matrix(generator: torch.Generator, m: int, n: int, k: int, *,
                   noise: float = 0.0, dtype=torch.float32) -> torch.Tensor:
    """Paper §6.1.1 dense synthetic: A = W H + noise·U with W (m, k),
    H (k, n) and U (m, n) uniform on [0, 1), on the generator's device.

    A is built in place, one chunk of rows at a time: W H and the noise of
    a chunk are formed in fp32 and written into A's rows, so the only
    temporaries are chunk-sized (the reference's ``A + noise * U`` would
    hold two more m×n arrays — 112 GB at the paper's Video shape).  The
    noise is drawn chunk by chunk (2^26 elements each), so the same seed
    gives the same A for the same shape.
    """
    dev = generator.device
    W = torch.rand((m, k), generator=generator, device=dev)
    H = torch.rand((k, n), generator=generator, device=dev)
    A = torch.empty((m, n), dtype=dtype, device=dev)
    chunk_rows = max(1, _CHUNK_ELEMS // max(1, n))
    for r0 in range(0, m, chunk_rows):
        blk = W[r0:r0 + chunk_rows] @ H
        if noise:
            U = torch.empty_like(blk).uniform_(generator=generator)
            blk.add_(U, alpha=noise)
        A[r0:r0 + chunk_rows] = blk
    return A


def erdos_renyi_bcoo(generator: torch.Generator, m: int, n: int,
                     density: float, dtype=torch.float32) -> torch.Tensor:
    """Paper §6.1.1 sparse synthetic in sparse storage: an Erdős–Rényi
    (m, n) matrix as a coalesced ``torch.sparse_coo_tensor`` (PyTorch's
    counterpart of BCOO), made on the generator's device.

    The reference draws a dense (m, n) mask, which is impossible at the
    sizes the sparse path runs (2^24 × 2^24).  This draws round(density ·
    m · n) linear indices uniformly, drops the duplicates (sorting them
    into row-major order, as ``BCOO.fromdense`` orders its triplets), and
    draws each value uniformly on (0, 1]: no stored value is 0, because
    zero-valued triplets are the layout's padding.  So the nonzero count
    is a little below round(density · m · n).  The streams differ from
    ``jax.random``'s: the same seed gives another matrix than the
    reference's ``erdos_renyi_bcoo``.
    """
    dev = generator.device
    draws = round(density * m * n)
    idx = torch.randint(0, m * n, (draws,), generator=generator, device=dev)
    idx = torch.unique(idx, sorted=True)
    vals = 1.0 - torch.rand(idx.numel(), generator=generator, device=dev)
    indices = torch.stack((idx // n, idx % n))
    del idx
    return torch.sparse_coo_tensor(indices, vals.to(dtype), (m, n),
                                   is_coalesced=True, check_invariants=False)
