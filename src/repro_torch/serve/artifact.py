"""Factor artifacts: the on-disk serving format for trained NMF factors.
Counterpart of ``repro/serve/artifact.py``.

An artifact bundles what a request path needs so nothing is recomputed per
query: the factors ``W`` (m, k) and ``H`` (k, n) as tensors on one device,
the precomputed Gram ``G = HHᵀ`` (k, k, fp32), the training algorithm and
free-form metadata (iterations, final relative error, provenance from
``NMFResult.extras``).

On disk an artifact is a ``repro_torch.checkpoint.checkpoint.write_payload``
directory (``arrays.npz`` + ``meta.json``, written to a tmp dir and renamed
into place), with the reference's ``meta.json`` keys and checksums, so an
artifact published by either package loads in the other.  numpy has no
bfloat16, so bf16 factors are saved as float32.

    res = NMFSolver(k, algo="bpp").fit(A)
    res.save_artifact("artifacts/topics")
    art = FactorArtifact.load("artifacts/topics")        # on cuda
    proj = FoldInProjector(art)                           # serve.foldin

``evolve()`` builds the next artifact of a lineage (``version`` bumped,
``parent_version`` and ``rows_absorbed`` recorded).

**Sharded artifacts:** ``shard(mesh)`` places W row-sharded over a 1-D
serve mesh (``serve.mesh.serve_mesh``) as a ``serve.mesh.ShardedRows``,
zero-padded to a multiple of the mesh size, the true row count in
``valid_rows`` (``shape``, ``save`` and ``transposed`` see the unpadded
matrix); H and the Gram stay on the mesh's first device, and the sharded
entry points (``FoldInProjector(mesh=...)``, ``TopK(mesh=...)``) copy them
to each shard's device once.  ``load(path, mesh=...)`` shards on load,
from the host: W is never whole on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.util.convert import to_numpy, to_torch
from repro_torch.util.device import resolve_device

FORMAT = "nmf-factor-artifact"
VERSION = 1

class ProjectionState(NamedTuple):
    """Per-artifact state a fold-in projection reuses across requests."""
    gram: torch.Tensor    # (k, k) fp32 — HHᵀ of the fixed factor
    diag: torch.Tensor    # (k,)  fp32 — its diagonal
    algo: str


def _gram_fp32(H: torch.Tensor) -> torch.Tensor:
    """HHᵀ (k, k) fp32 for H (k, n), through the ``gram`` kernel on Hᵀ
    (fp32 accumulation whatever H's dtype)."""
    return ops.gram(H.T.contiguous())


def _place(x, device) -> torch.Tensor:
    return to_torch(x, device=device).contiguous()


def _factor_device(W, device) -> torch.device:
    """``device`` resolved like every entry point; None keeps a tensor W's
    device (numpy factors then go to ``cuda``)."""
    if device is None and isinstance(W, torch.Tensor):
        return W.device
    return resolve_device(device)


@dataclasses.dataclass(frozen=True)
class FactorArtifact:
    """Trained factors + precomputed serving state.  Immutable.

    ``valid_rows`` is set on sharded artifacts, whose W (a ``ShardedRows``
    over ``mesh``) carries zero pad rows; everywhere the artifact is read
    as data — ``shape``, ``save``, ``transposed`` — the pad is invisible.
    """

    W: Any                # (m, k); ShardedRows (m_pad, k) when sharded
    H: Any                # (k, n)
    algo: str
    gram: Any             # (k, k) fp32, HHᵀ
    meta: dict = dataclasses.field(default_factory=dict)
    valid_rows: int | None = None   # true m when W is sharded; else None
    mesh: Any = None                # the serve mesh W is sharded over

    @property
    def k(self) -> int:
        return self.W.shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        m = self.W.shape[0] if self.valid_rows is None else self.valid_rows
        return (m, self.H.shape[1])

    @property
    def device(self) -> torch.device:
        return self.H.device

    # -- lineage -------------------------------------------------------------

    @property
    def version(self) -> int:
        """Lineage version (0 for artifacts published outside a lineage)."""
        return int(self.meta.get("version", 0))

    @property
    def parent_version(self) -> int | None:
        """Version of the artifact this one evolved from (None for roots)."""
        v = self.meta.get("parent_version")
        return None if v is None else int(v)

    @property
    def rows_absorbed(self) -> int:
        """Rows ingested between the parent artifact and this one."""
        return int(self.meta.get("rows_absorbed", 0))

    def evolve(self, W=None, H=None, *, rows_absorbed: int = 0,
               **meta) -> "FactorArtifact":
        """The next artifact in this lineage: ``version`` bumps by one and
        the parent version + rows absorbed since it are recorded.  Passing
        only ``W`` reuses the precomputed Gram; passing ``H`` recomputes
        it.  Free-form ``meta`` lands in the child's metadata."""
        W_new = self._unpadded_W() if W is None else _place(W, self.device)
        if H is None:
            H_new, gram = self.H, self.gram
        else:
            H_new = _place(H, self.device)
            gram = _gram_fp32(H_new)
        if W_new.dim() != 2 or W_new.shape[1] != H_new.shape[0]:
            raise ValueError(f"factor shapes do not compose: W "
                             f"{tuple(W_new.shape)} × H {tuple(H_new.shape)}")
        if H_new.shape[1] != self.H.shape[1]:
            raise ValueError(f"a lineage serves one feature space: H has "
                             f"{H_new.shape[1]} columns, parent has "
                             f"{self.H.shape[1]}")
        md = {k: v for k, v in self.meta.items()
              if k not in ("version", "parent_version", "rows_absorbed")}
        md.update(meta)
        md.update(version=self.version + 1, parent_version=self.version,
                  rows_absorbed=int(rows_absorbed))
        return FactorArtifact(W=W_new, H=H_new, algo=self.algo, gram=gram,
                              meta=md)

    def _unpadded_W(self) -> torch.Tensor:
        """W without its sharding pad, whole on the artifact's device."""
        if self.valid_rows is None:
            return self.W
        return self.W.full(self.device)[:self.valid_rows]

    # -- construction -------------------------------------------------------

    @classmethod
    def from_factors(cls, W, H, *, algo: str = "bpp", device=None,
                     **meta) -> "FactorArtifact":
        """From W (m, k) and H (k, n), tensors or numpy arrays, placed on
        ``device`` (None: a tensor W's device, else ``cuda``)."""
        return cls._build(W, H, algo, meta, _factor_device(W, device))

    @classmethod
    def _build(cls, W, H, algo, meta, device) -> "FactorArtifact":
        W, H = _place(W, device), _place(H, device)
        if W.dim() != 2 or H.dim() != 2 or W.shape[1] != H.shape[0]:
            raise ValueError(f"factor shapes do not compose: W "
                             f"{tuple(W.shape)} × H {tuple(H.shape)}")
        return cls(W=W, H=H, algo=algo, gram=_gram_fp32(H), meta=dict(meta))

    @classmethod
    def from_result(cls, result, **meta) -> "FactorArtifact":
        """Build from an ``NMFResult``, on its factors' device, keeping
        training provenance."""
        rels = np.asarray(result.rel_errors, np.float32)
        prov = {"iters": int(result.iters),
                "rel_error": float(rels[-1]) if rels.size else None,
                **{k: v for k, v in result.extras.items()
                   if isinstance(v, (str, int, float, bool))}}
        prov.update(meta)
        return cls._build(result.W, result.H, result.algo, prov,
                          _factor_device(result.W, None))

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> str:
        """Atomically publish to directory ``path`` (arrays.npz +
        meta.json).  A sharded artifact saves its unpadded W: the format
        on disk knows no mesh."""
        from repro_torch.checkpoint.checkpoint import write_payload
        W = (to_numpy(self.W) if self.valid_rows is None else
             np.concatenate([to_numpy(s) for s in self.W.shards])
             [:self.valid_rows])
        arrays = {"W": W, "H": to_numpy(self.H),
                  "gram": to_numpy(self.gram)}
        meta = {"format": FORMAT, "version": VERSION, "algo": self.algo,
                "k": int(self.k), "shape": list(self.shape),
                "meta": self.meta}
        return write_payload(path, arrays, meta)

    @classmethod
    def load(cls, path: str, *, device=None, mesh=None) -> "FactorArtifact":
        """Read and verify an artifact (either package's) onto ``device``
        (None: ``cuda``, as every entry point), or with ``mesh`` sharded
        over that serve mesh (``shard``), W split from the host."""
        from repro_torch.checkpoint.checkpoint import read_payload
        if mesh is not None:
            if device is not None:
                raise ValueError("pass device= or mesh=, not both")
            return cls.load(path, device="cpu").shard(mesh)
        device = resolve_device(device)
        arrays, meta = read_payload(path)
        if meta.get("format") != FORMAT:
            raise ValueError(f"{path} is not a {FORMAT} payload "
                             f"(format={meta.get('format')!r})")
        if meta.get("version", 0) > VERSION:
            raise ValueError(f"artifact version {meta['version']} is newer "
                             f"than this reader (supports ≤ {VERSION})")
        return cls(W=_place(arrays["W"], device),
                   H=_place(arrays["H"], device), algo=meta["algo"],
                   gram=_place(arrays["gram"], device),
                   meta=dict(meta.get("meta", {})))

    def shard(self, mesh) -> "FactorArtifact":
        """Place this artifact on a 1-D serve mesh: W row-sharded
        (``ShardedRows``: zero pad rows up to a multiple of the mesh size,
        ``valid_rows`` the true count), H and the Gram on the mesh's first
        device.  Re-sharding a sharded artifact re-pads from its valid
        rows."""
        from repro_torch.serve.mesh import ShardedRows, mesh_devices
        dev0 = mesh_devices(mesh)[0]
        W = self._unpadded_W()
        return dataclasses.replace(
            self, W=ShardedRows.split(W, mesh), H=self.H.to(dev0),
            gram=self.gram.to(dev0), valid_rows=W.shape[0], mesh=mesh)

    # -- serving state ------------------------------------------------------

    def projection_state(self) -> ProjectionState:
        G = self.gram.float()
        return ProjectionState(gram=G, diag=torch.diagonal(G), algo=self.algo)

    def transposed(self) -> "FactorArtifact":
        """The (Hᵀ, Wᵀ) view: fold COLUMNS of A (e.g. new frames, or new
        documents of a vocab×docs matrix) through the same row fold-in
        API.  A sharded W loses its pad rows first (they would become
        phantom columns of the transposed H)."""
        Wt = self._unpadded_W().T.contiguous()
        return FactorArtifact(W=self.H.T.contiguous(), H=Wt, algo=self.algo,
                              gram=_gram_fp32(Wt),
                              meta=dict(self.meta, transposed=True))
