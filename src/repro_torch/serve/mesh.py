"""Mesh-sharded serving: one handle that serves an artifact from N devices.
Counterpart of ``repro/serve/mesh.py``.

The reference's serve mesh is a 1-D JAX device mesh under one controller
(one process, ``shard_map`` over the devices).  The port keeps that
design: ``serve_mesh(n, devices=)`` returns a ``ServeMesh``, an ordered
tuple of ``torch.device``s under the axis name ``"serve"``, and every
sharded entry point is driven by the one calling process, shard by shard.
One device may appear more than once — the port's counterpart of the
reference's forced host devices: ``serve_mesh(8, devices=["cpu"] * 8)``
runs eight shards on the CPU, ``serve_mesh(4, devices=["cuda:0"] * 4)``
four on one card.

    artifact ── shard(mesh) ──► W row-sharded (ShardedRows), H/Gram replicated
        ├─ FoldInProjector(mesh=…)   sharded batched NNLS fold-in
        ├─ TopK(mesh=…)              per-shard streaming scan + merge
        └─ MicroBatcher              request coalescing over the sharded
                                     projector (submit → Future)

``MeshServer`` keeps the single-device API (``project`` / ``submit`` /
``query`` / ``retrieve``) while W spreads over the mesh.
``swap(artifact_or_path)`` hot-reloads: the replacement is sharded and
warmed off the request path, then published to the batcher at a batch
boundary; a swap to a lower lineage version is refused and logged.

    mesh = serve_mesh(4)
    with MeshServer(FactorArtifact.load(path), mesh=mesh) as srv:
        x = srv.submit(row).result()          # coalesced sharded fold-in
        scores, idx = srv.retrieve(row, k=5)  # fold + sharded top-k

Only k-wide data crosses between shards: the (b, k) top-k candidate sets,
a features shard's (b, k) partial product, and each batch shard's (b/p, k)
codes on their way back to the caller.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from repro_torch.obs.log import get_logger, log_event
from repro_torch.obs.trace import span as _span
from repro_torch.util.device import resolve_device


@dataclass(frozen=True)
class ServeMesh:
    """A 1-D serve mesh: shard s runs on ``devices[s]``."""

    devices: tuple
    axis: str = "serve"

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis,)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def serve_mesh(n: int | None = None, *, devices=None,
               axis: str = "serve") -> ServeMesh:
    """A 1-D mesh of ``n`` shards.  ``devices`` (a sequence of devices or
    device strings; one may repeat) lists each shard's device; None takes
    the visible cards, ``cuda:0`` … (raises without a card).  ``n`` takes
    the first ``n`` of them (None: all)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if n is not None:
        if n > len(devices):
            raise ValueError(f"asked for a {n}-shard serve mesh but only "
                             f"{len(devices)} devices were given or are "
                             f"visible")
        devices = devices[:n]
    if not devices:
        raise ValueError("a serve mesh needs at least one device")
    return ServeMesh(devices=tuple(devices), axis=axis)


def mesh_devices(mesh) -> tuple:
    """The shard devices of a serve mesh; anything else raises."""
    if not isinstance(mesh, ServeMesh):
        raise TypeError(f"serving shards over a 1-D serve mesh "
                        f"(serve.mesh.serve_mesh); got "
                        f"{type(mesh).__name__}")
    return mesh.devices


class ShardedRows:
    """A (rows, k) matrix split by rows over a serve mesh: ``shards[s]``,
    on ``mesh.devices[s]``, holds rows s·r … (s + 1)·r - 1, every shard r
    rows (zero-padded at the end)."""

    def __init__(self, shards, mesh: ServeMesh):
        self.shards, self.mesh = tuple(shards), mesh

    @property
    def shape(self) -> tuple[int, int]:
        return (sum(s.shape[0] for s in self.shards), self.shards[0].shape[1])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @classmethod
    def split(cls, X: torch.Tensor, mesh: ServeMesh) -> "ShardedRows":
        """X's rows over the mesh, the last shards zero-padded; each shard
        made on its device from X's rows (X is never padded whole)."""
        devs = mesh_devices(mesh)
        p, m = len(devs), X.shape[0]
        r = -(-m // p)
        shards = []
        for s, dev in enumerate(devs):
            part = X[min(s * r, m):min((s + 1) * r, m)].to(dev)
            if part.shape[0] < r:
                part = torch.cat([part, part.new_zeros(
                    (r - part.shape[0],) + tuple(X.shape[1:]))])
            shards.append(part.contiguous())
        return cls(shards, mesh)

    def full(self, device) -> torch.Tensor:
        """The whole padded matrix on ``device``."""
        return torch.cat([s.to(device) for s in self.shards])


class MeshServer:
    """Sharded serving facade: fold-in + top-k + microbatching over one
    mesh-placed artifact.  Thread-safe; ``swap`` hot-reloads atomically."""

    def __init__(self, artifact, *, mesh=None, algo=None, backend=None,
                 iters: int = 100, max_batch: int = 256,
                 shard: str = "batch", metric: str = "cosine",
                 chunk: int | None = None, merge: str = "auto",
                 max_delay_s: float = 2e-3, warmup: bool = True):
        from repro_torch.serve.batcher import MicroBatcher
        self.mesh = mesh if mesh is not None else serve_mesh()
        mesh_devices(self.mesh)
        self._algo, self._backend, self._iters = algo, backend, iters
        self._max_batch, self._shard = max_batch, shard
        self._metric, self._chunk, self._merge = metric, chunk, merge
        self._warmup = warmup
        self._lock = threading.Lock()
        self.artifact, self.projector, self.topk = self._build(artifact)
        self.batcher = MicroBatcher(self.projector.project,
                                    max_batch=max_batch,
                                    max_delay_s=max_delay_s)

    def _build(self, artifact):
        from repro_torch.serve.artifact import FactorArtifact
        from repro_torch.serve.foldin import FoldInProjector
        from repro_torch.serve.topk import TopK
        if isinstance(artifact, FactorArtifact):
            art = artifact.shard(self.mesh)
        else:
            art = FactorArtifact.load(artifact, mesh=self.mesh)
        proj = FoldInProjector(art, algo=self._algo, backend=self._backend,
                               iters=self._iters, max_batch=self._max_batch,
                               mesh=self.mesh, shard=self._shard)
        topk = TopK(art, metric=self._metric, chunk=self._chunk,
                    mesh=self.mesh, merge=self._merge)
        if self._warmup:
            proj.warmup()
        return art, proj, topk

    # -- request path -------------------------------------------------------

    def project(self, rows):
        """Sharded batched fold-in, bypassing the batcher (bulk clients)."""
        with self._lock:
            proj = self.projector
        return proj.project(rows)

    def submit(self, row):
        """Coalesced single-row fold-in; resolves to the (k,) code."""
        return self.batcher.submit(row)

    def query(self, latent_codes, *, k: int = 10):
        """Sharded top-k over already-projected latent codes."""
        with self._lock:
            topk = self.topk
        return topk.query(latent_codes, k=k)

    def retrieve(self, rows, *, k: int = 10):
        """Fold new rows in, then retrieve their top-k W rows (both from
        one artifact, even across a concurrent swap)."""
        with self._lock:
            proj, topk = self.projector, self.topk
        return topk.query(proj.project(rows), k=k)

    # -- lifecycle ----------------------------------------------------------

    @property
    def version(self) -> int:
        """Lineage version of the artifact currently served (see
        ``FactorArtifact.evolve``); 0 outside a lineage."""
        return self.artifact.version

    def swap(self, artifact) -> None:
        """Hot-reload a new artifact (a ``FactorArtifact`` or a saved
        artifact's path): shard, build and warm the replacement off the
        request path, then publish it to the batcher at a batch boundary.

        Lineage versions must move forward: swapping in a version lower
        than the one served is refused (``ValueError``) and logged as a
        ``swap_refused`` event.  Equal versions pass: artifacts published
        outside a lineage all carry version 0."""
        log = get_logger("serve.mesh")
        with _span("mesh.swap"):
            art, proj, topk = self._build(artifact)
            if art.version < self.artifact.version:
                log_event(log, "swap_refused",
                          served_version=self.artifact.version,
                          offered_version=art.version,
                          offered_parent=art.parent_version)
                raise ValueError(
                    f"stale swap: artifact version {art.version} < served "
                    f"version {self.artifact.version}; an online lineage "
                    f"only moves forward")
            self.batcher.swap(proj.project)
            with self._lock:
                self.artifact, self.projector, self.topk = art, proj, topk
        log_event(log, "swap", version=art.version,
                  parent_version=art.parent_version, rows=art.shape[0])

    def close(self) -> None:
        self.batcher.close()

    def __enter__(self) -> "MeshServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
