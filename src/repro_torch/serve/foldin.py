"""Online fold-in: project new data rows into a trained NMF latent space —
single-device or sharded over a serve mesh.  Counterpart of
``repro/serve/foldin.py``.

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
``warmup()`` builds the kernels and runs every bucket once.

**Sharded fold-in** (``mesh=``, a ``serve.mesh.serve_mesh``): the calling
process drives every shard in turn, each on its own device with its own
copies of the fixed operands, through the same kernels:

  * ``shard="batch"`` (default) splits the REQUEST rows over the mesh
    (buckets are multiples of the mesh size); each shard folds its own
    rows and only its (b/p, k) codes come back to the caller;
  * ``shard="features"`` splits Hᵀ's feature rows (zero-padded to a
    multiple of the mesh size): each shard contracts its feature slice,
    the (B, k) partial products are summed on every shard in shard order
    (the reference's k-wide psum) and every shard folds the sum, as every
    device does in the reference;
  * sparse requests shard over the batch only; their triplets split by
    row, and ``SparseOps(spmm_impl="sorted")`` serves here (each shard's
    triplets sorted on its device), as in the reference.

``project`` records into the process registry (``repro_torch.obs``,
the reference's names): ``serve_foldin_rows_total`` and
``serve_foldin_project_latency_s``, and a ``foldin.project`` span when the
default tracer is enabled.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from repro_torch import backends as _backends
from repro_torch.backends import SparseOps
from repro_torch.core import blocksparse, rules as _rules
from repro_torch.obs.metrics import default_registry as _default_registry
from repro_torch.obs.trace import span as _span
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

    ``mesh`` (a ``serve.mesh.ServeMesh``) shards the projection over its
    devices (``device`` must then be None: results land on the mesh's
    first device); ``shard`` picks the axis — "batch" splits request rows,
    "features" splits Hᵀ's feature rows.  Results match the single-device
    path to float tolerance.
    """

    def __init__(self, factor, *, algo: "_rules.RuleSpec | None" = None,
                 backend: "_backends.BackendSpec | None" = None,
                 iters: int = 100, max_batch: int = 256,
                 buckets: tuple[int, ...] | None = None,
                 mesh=None, shard: str = "batch", device=None):
        if shard not in _SHARD_MODES:
            raise ValueError(f"shard must be one of {_SHARD_MODES}, got "
                             f"{shard!r}")
        if mesh is not None:
            from repro_torch.serve.mesh import mesh_devices
            devices = mesh_devices(mesh)
            if device is not None:
                raise ValueError("a sharded projector runs on its mesh's "
                                 "devices: pass mesh= or device=, not both")
        else:
            devices = (resolve_device(device),)
        self.mesh, self.shard = mesh, shard
        self._devices, self._p = devices, len(devices)
        self.device = devices[0]
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
            if ops.spmm_impl == "sorted" and mesh is None:
                raise ValueError(
                    "single-device fold-in takes each request's triplets as "
                    "they come, without the sort_rows layout — use "
                    "spmm_impl='auto'/'scatter'/'cuda', or a mesh (sharded "
                    "fold-in sorts each shard's triplets)")
            self._dense_ops = _backends.get_backend("cuda")
            self._sparse_ops = ops
        else:
            self._dense_ops = ops
            self._sparse_ops = SparseOps()

        self.max_batch = int(max_batch)
        batch_mult = self._p if (mesh is not None and shard == "batch") else 1
        self.buckets = tuple(sorted(set(
            buckets or default_buckets(self.max_batch, batch_mult))))
        if self.buckets[-1] < self.max_batch:
            raise ValueError(f"largest bucket {self.buckets[-1]} < "
                             f"max_batch {self.max_batch}")
        if batch_mult > 1 and any(b % batch_mult for b in self.buckets):
            raise ValueError(f"batch-sharded buckets must be multiples of "
                             f"the mesh size {batch_mult}; got "
                             f"{self.buckets}")

        # Each shard's fixed operands on its device, copied once (one copy
        # per distinct device).  Feature shards hold their slice of Hᵀ,
        # padded so the n axis divides evenly (zero feature rows add
        # nothing to R: exact).
        self._G = {d: self.G.to(d) for d in dict.fromkeys(devices)}
        if mesh is not None and shard == "features":
            self._n_run = self.n + (-self.n) % self._p
            Ht_run = torch.cat([self.Ht, self.Ht.new_zeros(
                (self._n_run - self.n, self.k))])
            ns = self._n_run // self._p
            self._Ht = [Ht_run[s * ns:(s + 1) * ns].to(d).contiguous()
                        for s, d in enumerate(devices)]
        else:
            self._n_run = self.n
            per_dev = {d: self.Ht.to(d) for d in dict.fromkeys(devices)}
            self._Ht = [per_dev[d] for d in devices]

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
        BlockCOO — on the projector's device (a sharded projector's: its
        mesh's first device).  Values are cast to the factor's dtype,
        except that a bf16 batch stays bf16 beside fp32 factors (the
        product takes mixed operands, as the reference's does).

        Instrumented: rows into ``serve_foldin_rows_total``, the call's
        host seconds into ``serve_foldin_project_latency_s``, a
        ``foldin.project`` span when the default tracer is enabled."""
        t0 = _time.perf_counter()
        with _span("foldin.project"):
            out = self._project(rows)
        reg = _default_registry()
        reg.counter("serve_foldin_rows_total",
                    help="Rows folded into the latent space").inc(len(out))
        reg.histogram("serve_foldin_project_latency_s",
                      help="Fold-in dispatch seconds per batch").observe(
            _time.perf_counter() - t0)
        return out

    def _project(self, rows) -> torch.Tensor:
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
        keep = (isinstance(rows, torch.Tensor)
                and rows.dtype == torch.bfloat16)
        rows = to_torch(rows, device=self.device,
                        dtype=rows.dtype if keep else self.Ht.dtype)
        if rows.dim() == 1:
            rows = rows[None, :]
        b, n = rows.shape
        if n != self.n:
            raise ValueError(f"rows have {n} features, factor has {self.n}")
        B = self._bucket(b)
        if B != b or self._n_run != n:
            rows = torch.nn.functional.pad(rows, (0, self._n_run - n,
                                                  0, B - b))
        if self.mesh is None:
            R = self._dense_ops.mm(rows.contiguous(), self.Ht)
            return self._fold(self.G, R)[:b]
        devs, p = self._devices, self._p
        if self.shard == "batch":
            bs = B // p
            outs = [self._fold(self._G[d], self._dense_ops.mm(
                        rows[s * bs:(s + 1) * bs].to(d).contiguous(),
                        self._Ht[s]))
                    for s, d in enumerate(devs)]
            return torch.cat([o.to(self.device) for o in outs])[:b]
        ns = self._n_run // p
        parts = [self._dense_ops.mm(
                     rows[:, s * ns:(s + 1) * ns].to(d).contiguous(),
                     self._Ht[s])
                 for s, d in enumerate(devs)]
        codes = []
        for d in devs:
            R = parts[0].to(d)
            for part in parts[1:]:
                R = R + part.to(d)
            codes.append(self._fold(self._G[d], R))
        return codes[0][:b]

    def _project_triplets(self, shape, vals, rix, cix) -> torch.Tensor:
        b, n = shape
        if n != self.n:
            raise ValueError(f"rows have {n} features, factor has {self.n}")
        B = self._bucket(b)
        if self.mesh is None:
            return self._fold_triplets(0, B, vals, rix, cix)[:b]
        if self.shard != "batch":
            raise ValueError("sparse fold-in shards over the batch axis "
                             "only — build the projector with "
                             "shard='batch'")
        bs = B // self._p
        owner = rix // bs
        outs = []
        for s in range(self._p):
            sel = owner == s
            outs.append(self._fold_triplets(s, bs, vals[sel],
                                            rix[sel] - s * bs, cix[sel]))
        return torch.cat([o.to(self.device) for o in outs])[:b]

    def _fold_triplets(self, s: int, rows: int, vals, rix, cix):
        """Fold ``rows`` request rows given as triplets on shard ``s``'s
        device (the single-device projector is shard 0), the triplets
        padded to the nnz ladder."""
        dev = self._devices[s]
        nnz = vals.numel()
        L = self._nnz_bucket(nnz)
        pv = torch.zeros(L, dtype=self.Ht.dtype, device=dev)
        pr = torch.zeros(L, dtype=torch.int32, device=dev)
        pc = torch.zeros(L, dtype=torch.int32, device=dev)
        pv[:nnz] = vals.to(dev)
        pr[:nnz] = rix.to(dev, torch.int32)
        pc[:nnz] = cix.to(dev, torch.int32)
        blk = blocksparse.BlockCOO(
            vals=pv.reshape(1, 1, L), rows=pr.reshape(1, 1, L),
            cols=pc.reshape(1, 1, L), shape=(rows, self.n),
            block_shape=(rows, self.n), nnz=L)
        ops = self._sparse_ops
        if ops.spmm_impl == "sorted":
            blk = blk.sort_rows(align=ops.align, orient="rows")
        R = ops.mm(blk, self._Ht[s])
        return self._fold(self._G[dev], R)

    def warmup(self, *, dense: bool = True, sparse: bool = False,
               nnz_per_row: int = 4) -> None:
        """Build the kernels (on the card) and run every bucket once:
        dense rows, and with ``sparse`` every rung of the nnz ladder up to
        ``nnz_per_row`` nonzeros per padded row."""
        if any(d.type == "cuda" for d in self._devices):
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
        for d in dict.fromkeys(self._devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
