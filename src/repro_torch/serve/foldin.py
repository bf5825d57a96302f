"""Online fold-in: project new data rows into a trained NMF latent space.
Counterpart of ``repro/serve/foldin.py``, single-device.

Serving runs one half-iteration of AU-NMF with the trained factor held
FIXED: given new rows ``A_new`` (b, n) and the trained ``H`` (k, n), solve
per row

    x_i = argmin_{x >= 0} || a_i - x H ||_2  =  fold(G, R),
    G = HHᵀ (precomputed),  R = A_new Hᵀ

through the update rule's own ``fold_in`` hook (``core.rules``): BPP exact,
HALS/MU iterated (the ``hals_sweep`` / ``mu_update`` kernels), the
accelerated rules with their stall exit.  The cross product R is the only
operation touching request data, and it goes through the backend layer:

  * dense rows  → the backend's ``mm`` (``backend="cuda"``, the default:
    the ``ts_matmul`` kernel);
  * sparse rows → a ``torch.sparse_coo_tensor`` or a 1×1-grid ``BlockCOO``,
    through ``SparseOps().mm`` (on the card, "auto" on unsorted triplets:
    the ``spmm`` kernel).

Batches are zero-padded up to a ladder of bucket sizes, and sparse
triplets to a power-of-two nnz ladder, as in the reference; padding rows
fold to x = 0 and are sliced off.  PyTorch has no jit cache, so the
reference's ``compile_count`` and ``lower_dense`` have no counterpart here;
``warmup()`` builds the kernels and runs every bucket once.  Sharded
fold-in (``mesh=``, ``shard=``) and the ``repro.obs`` metrics and spans are
not ported yet (ROADMAP.md queue 1 items 10 and 11).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import backends as _backends
from repro_torch.backends import SparseOps
from repro_torch.core import blocksparse, rules as _rules
from repro_torch.serve.artifact import FactorArtifact, _gram_fp32
from repro_torch.util.convert import to_torch
from repro_torch.util.device import resolve_device

#: nnz padding floor for sparse requests (keeps the shape ladder short)
_MIN_NNZ_BUCKET = 64

_SHARD_MODES = ("batch", "features")


def default_buckets(max_batch: int, multiple: int = 1) -> tuple[int, ...]:
    """Power-of-two ladder 1, 2, 4, … capped at (and including) max_batch.
    ``multiple`` makes every rung divisible by it (multiple, 2·multiple, …
    capped at max_batch rounded up)."""
    if multiple <= 1:
        out, b = [], 1
        while b < max_batch:
            out.append(b)
            b *= 2
        return tuple(out) + (max_batch,)
    cap = max_batch + (-max_batch) % multiple
    out, b = [], multiple
    while b < cap:
        out.append(b)
        b *= 2
    return tuple(out) + (cap,)


class FoldInProjector:
    """Batched NNLS projection of new rows against a fixed trained factor.

    >>> art = FactorArtifact.load("artifacts/topics")
    >>> proj = FoldInProjector(art, max_batch=64)
    >>> X = proj.project(new_rows)    # (b, n) dense or sparse -> (b, k) fp32

    ``factor`` is a ``FactorArtifact`` or a raw (k, n) factor (pass ``W.T``
    to fold new *columns* of A).  ``algo`` is a registered name or an
    ``UpdateRule`` (default: the artifact's training algorithm).
    ``backend`` computes the dense-row cross product (a ``SparseOps``
    instance instead configures the sparse path).  ``iters`` bounds the
    iterative rules' sweeps.  ``device`` is where the projection runs
    (None: ``cuda``); the factor is copied there once.
    """

    def __init__(self, factor, *, algo: "_rules.RuleSpec | None" = None,
                 backend: "_backends.BackendSpec | None" = None,
                 iters: int = 100, max_batch: int = 256,
                 buckets: tuple[int, ...] | None = None,
                 mesh=None, shard: str = "batch", device=None):
        if shard not in _SHARD_MODES:
            raise ValueError(f"shard must be one of {_SHARD_MODES}, got "
                             f"{shard!r}")
        if mesh is not None or shard != "batch":
            raise NotImplementedError(
                "sharded fold-in (mesh=, shard='features') is not ported yet "
                "(ROADMAP.md queue 1 item 10, mesh serving)")
        self.device = resolve_device(device)
        if isinstance(factor, FactorArtifact):
            H = factor.H.to(self.device)
            algo = algo if algo is not None else factor.algo
            G = factor.gram.to(self.device, torch.float32)
        else:
            H = to_torch(factor, device=self.device)
            if H.dim() != 2:
                raise ValueError(f"fixed factor must be (k, n), got shape "
                                 f"{tuple(H.shape)}")
            algo = algo if algo is not None else "bpp"
            G = _gram_fp32(H)
        rule = _rules.get_rule(algo)
        self.algo = rule.name
        self.k, self.n = H.shape
        self.Ht = H.T.contiguous()           # (n, k) — the mm operand
        self.G = G.contiguous()
        #: lineage version of the served artifact (0 outside a lineage)
        self.version = factor.version if isinstance(factor,
                                                    FactorArtifact) else 0
        self._fold = lambda G, R: rule.fold_in(G, R, iters=iters)

        ops = _backends.get_backend(backend if backend is not None
                                    else "cuda")
        if isinstance(ops, SparseOps):
            if ops.spmm_impl == "sorted":
                raise ValueError(
                    "single-device fold-in takes each request's triplets as "
                    "they come, without the sort_rows layout — use "
                    "spmm_impl='auto'/'scatter'/'cuda'")
            self._dense_ops = _backends.get_backend("cuda")
            self._sparse_ops = ops
        else:
            self._dense_ops = ops
            self._sparse_ops = SparseOps()

        self.max_batch = int(max_batch)
        self.buckets = tuple(sorted(set(
            buckets or default_buckets(self.max_batch))))
        if self.buckets[-1] < self.max_batch:
            raise ValueError(f"largest bucket {self.buckets[-1]} < "
                             f"max_batch {self.max_batch}")

    # -- bucketing ----------------------------------------------------------

    def _bucket(self, b: int) -> int:
        if b <= 0:
            raise ValueError(f"empty request batch (b={b})")
        if b > self.buckets[-1]:
            raise ValueError(f"batch of {b} rows exceeds max_batch="
                             f"{self.buckets[-1]}; split the request or "
                             f"raise max_batch")
        return next(s for s in self.buckets if s >= b)

    @staticmethod
    def _nnz_bucket(nnz: int) -> int:
        b = _MIN_NNZ_BUCKET
        while b < nnz:
            b *= 2
        return b

    # -- public API ---------------------------------------------------------

    def project(self, rows) -> torch.Tensor:
        """Latent codes (b, k) fp32 for a (b, n) batch of rows — a dense
        tensor or numpy array, a sparse COO tensor, or a 1×1-grid
        BlockCOO — on the projector's device.  Values are cast to the
        factor's dtype."""
        if isinstance(rows, blocksparse.BlockCOO):
            if rows.grid != (1, 1):
                raise ValueError("fold-in takes a 1×1-grid BlockCOO (a "
                                 "request batch is not distributed)")
            return self._project_triplets(
                rows.shape, rows.vals.reshape(-1), rows.rows.reshape(-1),
                rows.cols.reshape(-1))
        if isinstance(rows, torch.Tensor) and rows.layout != torch.strided:
            if rows.layout == torch.sparse_csr:
                rows = rows.to_sparse_coo()
            idx = rows._indices()
            return self._project_triplets(rows.shape, rows._values(),
                                          idx[0], idx[1])
        rows = to_torch(rows, device=self.device, dtype=self.Ht.dtype)
        if rows.dim() == 1:
            rows = rows[None, :]
        b, n = rows.shape
        if n != self.n:
            raise ValueError(f"rows have {n} features, factor has {self.n}")
        B = self._bucket(b)
        if B != b:
            rows = torch.cat([rows, rows.new_zeros((B - b, n))])
        R = self._dense_ops.mm(rows.contiguous(), self.Ht)
        return self._fold(self.G, R)[:b]

    def _project_triplets(self, shape, vals, rix, cix) -> torch.Tensor:
        b, n = shape
        if n != self.n:
            raise ValueError(f"rows have {n} features, factor has {self.n}")
        B = self._bucket(b)
        nnz = vals.numel()
        L = self._nnz_bucket(nnz)
        dev = self.device
        pv = torch.zeros(L, dtype=self.Ht.dtype, device=dev)
        pr = torch.zeros(L, dtype=torch.int32, device=dev)
        pc = torch.zeros(L, dtype=torch.int32, device=dev)
        pv[:nnz] = vals.to(dev)
        pr[:nnz] = rix.to(dev, torch.int32)
        pc[:nnz] = cix.to(dev, torch.int32)
        blk = blocksparse.BlockCOO(
            vals=pv.reshape(1, 1, L), rows=pr.reshape(1, 1, L),
            cols=pc.reshape(1, 1, L), shape=(B, n), block_shape=(B, n),
            nnz=L)
        R = self._sparse_ops.mm(blk, self.Ht)
        return self._fold(self.G, R)[:b]

    def warmup(self, *, dense: bool = True, sparse: bool = False,
               nnz_per_row: int = 4) -> None:
        """Build the kernels (on the card) and run every bucket once:
        dense rows, and with ``sparse`` every rung of the nnz ladder up to
        ``nnz_per_row`` nonzeros per padded row."""
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build()
        rng = np.random.RandomState(0)
        for B in self.buckets:
            if dense:
                self.project(rng.rand(B, self.n).astype(np.float32))
            if sparse:
                top = self._nnz_bucket(max(B * nnz_per_row, 1))
                L = _MIN_NNZ_BUCKET
                while L <= top:
                    idx = np.stack([rng.randint(0, B, L),
                                    rng.randint(0, self.n, L)])
                    self.project(torch.sparse_coo_tensor(
                        torch.from_numpy(idx),
                        torch.from_numpy(rng.rand(L).astype(np.float32)),
                        (B, self.n)))
                    L *= 2
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
