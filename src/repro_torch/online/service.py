"""OnlineNMF: the closed train→serve loop — ingest a growing row stream
while serving top-k the whole time.  Counterpart of
``repro/online/service.py``.

A trained NMF ends at a frozen ``FactorArtifact``; serving folds new rows
against it but the factors never move.  DID (Gao & Chu, arXiv:1802.08938)
supplies the missing middle: incremental block coordinate descent where
arriving rows are folded in as a warm start and only the *touched* blocks
of H are refreshed, with scheduled full refactorizations once drift
accumulates.  ``OnlineNMF`` is that loop, built from parts that already
exist:

    ingest(rows)                         serve (concurrent, any thread)
      │                                     │
      ├─ FoldInProjector.project   ◄─ warm-start codes = the serving path
      ├─ DriftAccumulator.observe         │
      ├─ one of                           │
      │    extend    W grows, H/Gram reused (no numeric work)
      │    refresh   UpdateRule.partial_update_h on touched H columns
      │    refactor  NMFSolver.fit(A_accum, init=(W, H)) warm start
      └─ publish: FactorArtifact.evolve (version++, lineage recorded)
                  → MicroBatcher.swap at a batch boundary

**Consistency is the contract.**  Every response is computed against ONE
artifact version — the projection closure captures the projector and its
version together, and the batcher samples the closure once per coalesced
batch, so a publish landing mid-traffic can never mix factors from two
versions inside one response.  Each response carries its version stamp
(``ServeResult.version``), which is also how staleness is *measured*: a
response whose stamp is older than the latest published version at
delivery time counts as stale (``stats.stale_queries``).

The accumulated matrix lives on the solver's device, in a row-capacity
buffer whose prefix is the matrix: an ingest writes its rows after the
prefix and never copies the store (it starts with a quarter of A0's rows
as headroom and doubles when full, an amortised copy).  W grows the same way.  A published artifact holds views
of those prefixes, which later ingests never write into: ``extend`` and
``refresh`` only append rows of W (``refresh`` publishes a new H), and a
refactorization moves W to a fresh buffer.  ``_partial_refresh`` forms
WᵀW and A[:, touched]ᵀW with the solver backend's ``gram`` and ``mm_t``
(on ``backend="cuda"``: the ``gram`` and ``ts_matmul_t`` kernels; a sparse
solver's products take these dense operands through the cuda backend's
wrappers) and sweeps the touched rows of Hᵀ with the rule's
``partial_update_h`` (the LUC kernels for mu and hals).
"""

from __future__ import annotations

import threading
from collections import Counter
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import backends as _backends
from repro_torch.core import rules as _rules
from repro_torch.core.aunmf import NMFResult
from repro_torch.core.blocksparse import BlockCOO
from repro_torch.core.engine import NMFSolver
from repro_torch.obs.log import get_logger, log_event
from repro_torch.obs.metrics import default_registry, next_instance_label
from repro_torch.obs.trace import span as _span
from repro_torch.online.drift import DriftAccumulator, block_slices
from repro_torch.serve.artifact import FactorArtifact
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.foldin import FoldInProjector
from repro_torch.serve.topk import TopK
from repro_torch.util.convert import to_torch

_log = get_logger("online.service")

#: elements of A in one chunk of ``rel_err`` (256 MiB of fp32)
_REL_ERR_CHUNK = 1 << 26


class ServeResult(NamedTuple):
    """One served projection: the latent code and the artifact version it
    was computed against (the staleness stamp)."""
    code: Any
    version: int


class IngestReport(NamedTuple):
    """What one ``ingest`` call did."""
    action: str                 # "extend" | "refresh" | "refactor"
    version: int                # artifact version this batch published as
    rows: int
    touched_blocks: tuple       # block indices refreshed ("refresh" only)
    drift_total: float          # accumulated drift AFTER this ingest
    rel_err: float | None       # final rel error ("refactor" only)


class OnlineStats:
    """Counters of the loop's life so far, as a live view over registry
    series (``repro_torch.obs.metrics``) under one process-unique
    ``instance`` label — the attribute API (``ingested_rows``,
    ``publishes``, ``served_by_version``, ...) reads straight through to
    them, and a Prometheus scrape of the registry sees every live service:

        online_ingested_rows_total / online_ingest_batches_total
        online_publishes_total
        online_publish_decisions_total{decision=extend|refresh|refactor}
        online_queries_total / online_stale_queries_total
        online_served_total{version=...}

    ``stale_queries`` counts responses whose version stamp was already
    superseded at delivery — the measured staleness of the serve path.
    ``served_by_version`` stays a ``collections.Counter`` mirrored into the
    per-version labelled counters."""

    _DECISIONS = ("extend", "refresh", "refactor")

    def __init__(self, registry=None):
        self._reg = registry or default_registry()
        self._labels = {"instance": next_instance_label()}
        c = lambda name, **kw: self._reg.counter(
            name, labels=dict(self._labels, **kw.pop("extra", {})), **kw)
        self._ingested = c("online_ingested_rows_total",
                           help="Rows absorbed into the accumulated matrix")
        self._batches = c("online_ingest_batches_total",
                          help="Ingest batches processed")
        self._publishes = c("online_publishes_total",
                            help="Artifact versions published")
        self._decisions = {d: c("online_publish_decisions_total",
                                extra={"decision": d},
                                help="Publishes by drift-ladder decision")
                           for d in self._DECISIONS}
        self._queries = c("online_queries_total",
                          help="Rows served (projected or retrieved)")
        self._stale = c("online_stale_queries_total",
                        help="Served rows stamped with a superseded version")
        self._lock = threading.Lock()
        self.served_by_version: Counter = Counter()

    # -- recorders (thread-safe) --------------------------------------------

    def record_ingest(self, rows: int) -> None:
        self._ingested.inc(rows)
        self._batches.inc()

    def record_decision(self, action: str) -> None:
        self._decisions[action].inc()

    def record_publish(self) -> None:
        self._publishes.inc()

    def record_serve(self, n: int, version: int, stale: bool) -> None:
        self._queries.inc(n)
        if stale:
            self._stale.inc(n)
        self._reg.counter("online_served_total",
                          labels=dict(self._labels, version=str(version)),
                          help="Served rows by artifact version").inc(n)
        with self._lock:
            self.served_by_version[version] += n

    # -- the attribute API, as counter reads --------------------------------

    @property
    def ingested_rows(self) -> int:
        return int(self._ingested.value)

    @property
    def batches(self) -> int:
        return int(self._batches.value)

    @property
    def publishes(self) -> int:
        return int(self._publishes.value)

    @property
    def extends(self) -> int:
        return int(self._decisions["extend"].value)

    @property
    def block_refreshes(self) -> int:
        return int(self._decisions["refresh"].value)

    @property
    def full_refactors(self) -> int:
        return int(self._decisions["refactor"].value)

    @property
    def queries(self) -> int:
        return int(self._queries.value)

    @property
    def stale_queries(self) -> int:
        return int(self._stale.value)

    @property
    def staleness(self) -> float:
        return self.stale_queries / max(self.queries, 1)


class _RowBuffer:
    """A row-capacity buffer whose first ``rows`` rows are the matrix:
    ``append`` writes after them (the buffer doubles when full), ``view``
    is the contiguous prefix.  Rows already written are never written
    again.  It starts with a quarter of the rows (at least ``capacity``
    rows in all) as headroom."""

    def __init__(self, X: torch.Tensor, capacity: int = 0):
        rows = X.shape[0]
        cap = max(capacity, rows + rows // 4)
        self.buf = torch.empty((cap,) + tuple(X.shape[1:]), dtype=X.dtype,
                               device=X.device)
        self.buf[:X.shape[0]] = X
        self.rows = X.shape[0]

    def append(self, X: torch.Tensor) -> None:
        need = self.rows + X.shape[0]
        if need > self.buf.shape[0]:
            grown = torch.empty((max(need, 2 * self.buf.shape[0]),)
                                + tuple(self.buf.shape[1:]),
                                dtype=self.buf.dtype, device=self.buf.device)
            grown[:self.rows] = self.buf[:self.rows]
            self.buf = grown
        self.buf[self.rows:need] = X
        self.rows = need

    def view(self) -> torch.Tensor:
        return self.buf[:self.rows]


class OnlineNMF:
    """A streaming NMF service: one object that trains, refreshes, and
    serves concurrently.

    >>> svc = OnlineNMF(A0, k=8, algo="bpp")
    >>> fut = svc.submit(row)                # serve thread(s)
    >>> svc.ingest(new_rows)                 # ingest thread
    >>> code, version = fut.result()
    >>> scores, idx, version = svc.retrieve(rows, k=5)

    ``A0`` seeds the accumulated matrix and the initial factorization
    (pass ``result=`` — an ``NMFResult`` of either package — to reuse a fit
    instead of training here).  Arriving batches (``ingest``: dense rows,
    or a sparse COO tensor / BlockCOO, which folds in sparse) are folded in
    as warm starts; the ``DriftAccumulator`` thresholds decide between the
    publishes:

      * ``extend`` — below both thresholds: W grows by the fold-in codes,
        H and the Gram are REUSED (no numeric work beyond the fold);
      * ``refresh`` — per-block drift tripped: only the touched columns of
        H are re-swept (``partial_update_h``) against the grown W;
      * ``refactor`` — total drift tripped: a full warm-started
        ``NMFSolver.fit(A, init=(W, H))`` over the accumulated matrix.

    Every publish is atomic and versioned; serving never blocks on ingest
    (requests in flight complete against the version they started with).
    ``mesh=`` (a ``repro_torch.serve.mesh.serve_mesh``) shards the serve
    path — W row-sharded, batch-sharded fold-in — while ingest stays on the
    solver's device.  Without ``solver=`` the solver is ``NMFSolver(k,
    algo=algo, backend=backend, device=device, max_iters=30, tol=1e-5)``,
    on ``cuda`` unless ``device="cpu"`` (the reference's default backend
    is ``dense``; the port's entry points default to the kernels).
    ``seed`` takes the place of the reference's ``key`` for the initial
    fit.
    """

    def __init__(self, A0, k: int | None = None, *,
                 algo: "_rules.RuleSpec" = "bpp", backend="cuda",
                 solver: NMFSolver | None = None, seed: int | None = None,
                 result=None, device=None,
                 n_blocks: int = 8, block_threshold: float = 0.25,
                 full_threshold: float = 2.0, refresh_sweeps: int = 1,
                 mesh=None, max_batch: int = 256, iters: int = 100,
                 max_delay_s: float = 2e-3, metric: str = "cosine",
                 chunk: int | None = None, warmup_on_publish: bool = False,
                 registry=None):
        if solver is None:
            if k is None:
                raise ValueError("pass k= (or a configured solver=)")
            solver = NMFSolver(k, algo=algo, backend=backend, device=device,
                               max_iters=30, tol=1e-5)
        self._solver = solver
        self.device = solver.device
        self.k = solver.k
        self._rule = _rules.get_rule(algo)
        self._iters = int(iters)
        self.refresh_sweeps = int(refresh_sweeps)
        self.mesh = mesh
        self._max_batch, self._metric, self._chunk = max_batch, metric, chunk
        self._warmup = warmup_on_publish

        A0 = self._densify(A0)
        self._A = _RowBuffer(A0)
        if result is None:
            result = solver.fit(self._A.view(), seed=seed)
        rels = np.asarray(result.rel_errors, np.float32)
        baseline = float(rels[-1]) if rels.size else 0.0
        W = to_torch(result.W, device=self.device, dtype=torch.float32)
        self._H = to_torch(result.H, device=self.device,
                           dtype=torch.float32).contiguous()
        if tuple(W.shape) != (A0.shape[0], self.k):
            raise ValueError(f"result W {tuple(W.shape)} does not match "
                             f"A0 rows × k {(A0.shape[0], self.k)}")
        self._W = _RowBuffer(W)
        self.n = A0.shape[1]
        self.drift = DriftAccumulator(self.n, n_blocks=n_blocks,
                                      baseline_rel_err=baseline,
                                      block_threshold=block_threshold,
                                      full_threshold=full_threshold)
        self._col_slices = block_slices(self.n, self.drift.n_blocks)

        self.stats = OnlineStats(registry)
        self._serve_lock = threading.Lock()
        root = NMFResult(W=self._W.view(), H=self._H,
                         rel_errors=torch.tensor(rels),
                         algo=getattr(result, "algo", self._rule.name),
                         iters=int(getattr(result, "iters", 0)),
                         extras=dict(getattr(result, "extras", {}) or {}))
        art = FactorArtifact.from_result(root)        # lineage root: v0
        self.artifact, self._projector, self._topk = self._build(art)
        self._latest_version = art.version
        self.batcher = MicroBatcher(self._make_project(), max_batch=max_batch,
                                    max_delay_s=max_delay_s,
                                    registry=registry)

    @classmethod
    def from_checkpoint(cls, A0, ckpt_dir: str, *, step: int | None = None,
                        k: int | None = None, **kw) -> "OnlineNMF":
        """Seed the online loop from an elastic training checkpoint (either
        package's, ``repro_torch.elastic``) instead of fitting here: the
        checkpointed factors become the lineage root (v0), so a run killed
        mid-training flows straight into serving — the checkpoint's step
        count and rel-error history ride along as the baseline the drift
        ladder measures against.  ``A0`` must be the matrix the checkpoint
        was trained on (its row count is validated against W)."""
        from repro_torch.elastic.remesh import load_checkpoint
        ck = load_checkpoint(ckpt_dir, step=step)
        if k is not None and k != ck.W.shape[1]:
            raise ValueError(f"k={k} does not match the checkpoint's "
                             f"rank {ck.W.shape[1]}")
        if "solver" not in kw and ck.fingerprint.get("algo"):
            kw.setdefault("algo", ck.fingerprint["algo"])
        return cls(A0, k=int(ck.W.shape[1]), result=ck.to_result(), **kw)

    # -- helpers -------------------------------------------------------------

    @staticmethod
    def _is_sparse(rows) -> bool:
        return isinstance(rows, BlockCOO) or (
            isinstance(rows, torch.Tensor) and rows.layout != torch.strided)

    def _densify(self, rows) -> torch.Tensor:
        """Rows as the store holds them: dense fp32 (b, n) on the solver's
        device (the store is an accumulator, not the serving path — sparse
        requests still fold in sparse)."""
        if isinstance(rows, BlockCOO):
            rows = rows.todense()
        if isinstance(rows, torch.Tensor) and rows.layout != torch.strided:
            rows = rows.to_dense()
        rows = to_torch(rows, device=self.device, dtype=torch.float32)
        return (rows[None, :] if rows.dim() == 1 else rows).contiguous()

    def _build(self, artifact: FactorArtifact):
        if self.mesh is not None:
            artifact = artifact.shard(self.mesh)
        proj = FoldInProjector(artifact, iters=self._iters,
                               max_batch=self._max_batch, mesh=self.mesh,
                               device=None if self.mesh else artifact.device)
        topk = TopK(artifact, metric=self._metric, chunk=self._chunk,
                    mesh=self.mesh)
        if self._warmup:
            proj.warmup()
        return artifact, proj, topk

    def _make_project(self):
        """The batcher's projection target: one closure per published
        version, capturing the (projector, version) pair together — a
        batch can never mix factors from two publishes.  Returns stamped
        per-request payloads (the batcher delivers list items verbatim),
        each code a row of the batch's codes on the host."""
        proj, version = self._projector, self._latest_version

        def project(rows):
            codes = proj.project(rows).cpu()
            self._record_serve(len(codes), version)
            return [ServeResult(code, version) for code in codes]

        return project

    def _record_serve(self, n: int, version: int) -> None:
        self.stats.record_serve(n, version, self._latest_version > version)

    def _publish(self, artifact: FactorArtifact) -> None:
        """Build + (optionally) warm the new serving state OFF the request
        path, then swap atomically: the batcher retargets at a batch
        boundary, retrieve() snapshots under the lock."""
        with _span("online.publish", version=artifact.version):
            art, proj, topk = self._build(artifact)
            with self._serve_lock:
                self.artifact, self._projector, self._topk = art, proj, topk
                self._latest_version = art.version
                project = self._make_project()
            with _span("online.swap", version=art.version):
                self.batcher.swap(project)
        self.stats.record_publish()

    # -- observable state ----------------------------------------------------

    @property
    def version(self) -> int:
        """Latest PUBLISHED artifact version."""
        return self._latest_version

    @property
    def shape(self) -> tuple[int, int]:
        return (self._A.rows, self.n)

    @property
    def A(self) -> torch.Tensor:
        """The accumulated matrix (a view of the store's prefix)."""
        return self._A.view()

    @property
    def W(self) -> torch.Tensor:
        return self._W.view().clone()

    @property
    def H(self) -> torch.Tensor:
        return self._H.clone()

    def rel_err(self) -> float:
        """Relative error of the CURRENT factors on the full accumulated
        matrix — the fidelity the oracle comparison (full retrain) is
        measured against — in row chunks on the device, the squares summed
        in float64."""
        A, W = self._A.view(), self._W.view()
        rows = max(1, _REL_ERR_CHUNK // self.n)
        num = torch.zeros((), dtype=torch.float64, device=self.device)
        den = torch.zeros((), dtype=torch.float64, device=self.device)
        for r0 in range(0, A.shape[0], rows):
            blk = A[r0:r0 + rows]
            E = blk - W[r0:r0 + rows] @ self._H
            num += torch.sum(torch.square(E), dtype=torch.float64)
            den += torch.sum(torch.square(blk), dtype=torch.float64)
        return float(torch.sqrt(num) / torch.clamp_min(torch.sqrt(den),
                                                       1e-30))

    # -- ingest path ---------------------------------------------------------

    def ingest(self, rows) -> IngestReport:
        """Absorb one arriving batch (dense (b, n) rows, or a sparse COO
        tensor / BlockCOO) and publish the successor artifact.
        Single-writer: call from one ingest thread (serving is concurrent
        and lock-free against it)."""
        dense = self._densify(rows)
        b, n = dense.shape
        if n != self.n:
            raise ValueError(f"ingest rows have {n} features, the stream "
                             f"has {self.n}")
        # Warm start: the serving fold-in IS the incremental W extension.
        # Sparse batches fold sparse; the dense copy only feeds the store
        # and the drift residual.
        fold_input = rows if self._is_sparse(rows) else dense
        with _span("online.ingest", rows=b):
            with _span("online.fold_in", rows=b):
                X = self._projector.project(fold_input).to(
                    self.device, torch.float32)
            with _span("online.drift"):
                self.drift.observe(dense, X, self._H)
            self._A.append(dense)
            self._W.append(X)
            self.stats.record_ingest(b)

            rel = None
            touched_idx: tuple = ()
            if self.drift.should_refactor():
                with _span("online.refactor"):
                    rel = self._refactor()
                art = self.artifact.evolve(W=self._W.view(), H=self._H,
                                           rows_absorbed=b, refresh="full",
                                           rel_error=rel)
                action = "refactor"
            elif (touched := self.drift.touched()).any():
                touched_idx = tuple(int(i) for i in np.nonzero(touched)[0])
                with _span("online.refresh", blocks=len(touched_idx)):
                    self._partial_refresh(touched)
                art = self.artifact.evolve(W=self._W.view(), H=self._H,
                                           rows_absorbed=b, refresh="blocks")
                self.drift.reset(touched)
                action = "refresh"
            else:
                # W grew by the fold-in codes; H (hence the Gram) is
                # untouched — evolve() reuses it, so this publish does no
                # numeric work.
                art = self.artifact.evolve(W=self._W.view(), rows_absorbed=b,
                                           refresh="extend")
                action = "extend"
            self.stats.record_decision(action)
            self._publish(art)
        log_event(_log, "publish", version=art.version,
                  parent_version=art.parent_version, decision=action,
                  rows=b, drift_total=round(self.drift.total, 6))
        return IngestReport(action=action, version=art.version, rows=b,
                            touched_blocks=touched_idx,
                            drift_total=self.drift.total, rel_err=rel)

    def _refresh_ops(self):
        """The local products of a refresh: the solver backend's, or for a
        sparse solver the cuda backend's wrappers (the store is dense)."""
        ops = self._solver.ops
        return _backends.get_backend("cuda") if ops.name == "sparse" else ops

    def _partial_refresh(self, touched) -> None:
        """DID-style partial sweep: gather the touched blocks' columns,
        refresh ONLY those rows of Hᵀ against the grown W, scatter into a
        new H (the published one stays as it was).  Cost is O(m·|touched
        cols|·k) for the cross product plus the gathered sweep — never the
        full O(m·n·k) refactorization."""
        cols = torch.cat([torch.arange(s.start, s.stop)
                          for s, t in zip(self._col_slices, touched) if t])
        cols = cols.to(self.device)
        W = self._W.view()
        m = W.shape[0]
        rule = self._rule.prepare_global(m, self.n, self.k)
        ops = self._refresh_ops()
        G = ops.gram(W)                                   # WᵀW, fp32
        At = self._A.view()[:, cols].contiguous()         # (m, w) touched
        Rt = ops.mm_t(At, W)                              # (w, k) fp32
        del At
        Xt = self._H[:, cols].T.contiguous()              # (w, k) rows of Hᵀ
        state = rule.init_state(m, self.n, self.k)
        for _ in range(max(self.refresh_sweeps, 1)):
            Xt, state = rule.partial_update_h(G, Rt, Xt, None, state)
        H = self._H.clone()
        H[:, cols] = Xt.T.to(H.dtype)
        self._H = H

    def _refactor(self) -> float:
        """Full warm-started refactorization over the accumulated matrix;
        W moves to a fresh buffer (published artifacts keep the old one);
        rebases the drift baseline on the fresh fit's final error."""
        res = self._solver.fit(self._A.view(), init=(self._W.view(),
                                                     self._H))
        self._W = _RowBuffer(res.W.to(torch.float32),
                             self._W.buf.shape[0])
        self._H = res.H.to(torch.float32).contiguous()
        rels = np.asarray(res.rel_errors, np.float32)
        rel = float(rels[-1]) if rels.size else self.rel_err()
        self.drift.reset_all(baseline_rel_err=rel)
        return rel

    # -- serve path ----------------------------------------------------------

    def submit(self, row):
        """Coalesced single-row projection; the future resolves to a
        ``ServeResult`` (code + the version stamp it was served from)."""
        return self.batcher.submit(row)

    def project(self, rows) -> ServeResult:
        """Batched projection against one consistent artifact snapshot."""
        with self._serve_lock:
            proj, version = self._projector, self._latest_version
        codes = proj.project(rows)
        self._record_serve(len(codes), version)
        return ServeResult(codes, version)

    def retrieve(self, rows, *, k: int = 10):
        """Fold rows in and retrieve their top-k W rows — both halves
        against the SAME artifact version; returns
        ``(scores, indices, version)``."""
        with self._serve_lock:
            proj, topk, version = self._projector, self._topk, \
                self._latest_version
        codes = proj.project(rows)
        scores, idx = topk.query(codes, k=k)
        self._record_serve(len(codes), version)
        return scores, idx, version

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        self.batcher.close()

    def __enter__(self) -> "OnlineNMF":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
