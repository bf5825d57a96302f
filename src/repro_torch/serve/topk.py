"""Top-k retrieval over trained factors: the nearest rows of W to a query's
latent code, scored in the k-dim space — single-device or sharded over a
serve mesh.  Counterpart of ``repro/serve/topk.py``.

With the precomputed Gram ``G = HHᵀ`` the reconstruction-space score of
row i collapses to a k-dim form (the Gram trick),

    ⟨w_i H, x H⟩ = w_i G xᵀ,

so a query is transformed once (``q̃ = x G``) and every row score is a
k-length dot; ``gram=None`` scores directly in latent space.  W streams
in ``chunk``-row tiles while a running (b, k) top-k set is merged per tile,
so no more than one (b, chunk) score block exists at a time.  The score
products are plain ``torch.matmul``, as the reference leaves them to XLA
outside any Pallas kernel.  ``chunk=None`` runs the measured autotuner
(``kernels/autotune``) over a ladder of tiles that always holds the hand
default, so the tuned choice is never slower (up to timer noise).

Every top-k keeps ``lax.top_k``'s order: scores descending, equal scores
by position (a stable sort), so ties resolve to the lower row index, as
in the reference.

**Sharded retrieval** (``mesh=``, a ``serve.mesh.ServeMesh``): W is
row-sharded (a sharded artifact's ``ShardedRows``, or split here).  Each
shard streams only its rows through the same chunked scan (global row
indices through the shard's row offset) into a (b, k) candidate set; the
sets then merge: ``"tree"``, the log₂ p pairwise exchange (partners at
distance 1, 2, 4, …, re-top-k after each hop, every shard ending with the
global top-k; a power-of-two mesh only), or ``"gather"``, one top-k over
all p·k candidates; ``"auto"`` picks tree where it can.  Only (b, k)
candidate sets cross between shards.

``TopK.query`` records into the process registry (``repro_torch.obs``):
``serve_topk_queries_total`` and ``serve_topk_query_latency_s``, and a
``topk.query`` span when the default tracer is enabled.
"""

from __future__ import annotations

import functools
import time as _time

import numpy as np
import torch

from repro_torch.obs.metrics import default_registry as _default_registry
from repro_torch.obs.trace import span as _span
from repro_torch.serve.artifact import FactorArtifact
from repro_torch.util.convert import to_torch
from repro_torch.util.device import resolve_device
from repro_torch.util.order import top_k as _top

_EPS = 1e-12

METRICS = ("dot", "cosine")

#: hand-picked streaming tile (rows of W scored per scan step); chunk=None
#: replaces it with the measured choice from kernels/autotune
DEFAULT_CHUNK = 4096
_CHUNK_CANDIDATES = (512, 1024, 2048, 4096, 8192, 16384)


def _row_norms(W: torch.Tensor, G: torch.Tensor, *,
               use_gram: bool) -> torch.Tensor:
    """‖w_i H‖ per row via the Gram (√(w_i G w_iᵀ)), or the latent ‖w_i‖:
    m·k² once per (W, G), which ``TopK`` keeps out of the request path."""
    Wf = W.float()
    base = (torch.sum((Wf @ G) * Wf, dim=1) if use_gram
            else torch.sum(Wf * Wf, dim=1))
    return torch.sqrt(torch.clamp_min(base, 0.0))


def _scan(W, Wn, Q, qnorm, *, k: int, metric: str, chunk: int,
          total_m: int, offset: int = 0):
    """The streaming chunk scan over one device's W rows: a running (b, k)
    set merged per tile.  ``offset`` is the rows' global offset (a shard's;
    0 on one device), so indices are global; rows at or past ``total_m``
    (global) score -inf."""
    m = W.shape[0]
    b = Q.shape[0]
    dev = Q.device
    vals = torch.full((b, k), float("-inf"), dtype=torch.float32, device=dev)
    idx = torch.full((b, k), -1, dtype=torch.int64, device=dev)
    for start in range(0, m, chunk):
        C = W[start:start + chunk].float()
        s = Q @ C.T                                          # (b, c)
        if metric == "cosine":
            cn = torch.clamp_min(Wn[start:start + chunk], _EPS)
            s = s / (cn[None, :] * qnorm[:, None])
        gidx = torch.arange(offset + start, offset + start + C.shape[0],
                            device=dev)
        if offset + start + C.shape[0] > total_m:
            s = torch.where((gidx < total_m)[None, :], s,
                            torch.full_like(s, float("-inf")))
        cand_v = torch.cat([vals, s], dim=1)
        cand_i = torch.cat([idx, gidx[None, :].expand(b, -1)], dim=1)
        vals, pos = _top(cand_v, k)
        idx = torch.gather(cand_i, 1, pos)
    return vals, idx


def _merge(vals: list, idx: list, *, k: int, merge: str):
    """The global (b, k) top-k from the shards' candidate sets, on shard
    0's device.  ``"tree"``: hop by hop, every shard i takes partner
    i ^ step's set (its own first) and keeps the top k; ``"gather"``: one
    top-k over every shard's set in shard order."""
    p = len(vals)
    if p == 1:
        return vals[0], idx[0]
    if merge == "tree":
        step = 1
        while step < p:
            nv, ni = [], []
            for i in range(p):
                j = i ^ step
                dev = vals[i].device
                cv = torch.cat([vals[i], vals[j].to(dev)], dim=1)
                ci = torch.cat([idx[i], idx[j].to(dev)], dim=1)
                v, pos = _top(cv, k)
                nv.append(v)
                ni.append(torch.gather(ci, 1, pos))
            vals, idx = nv, ni
            step *= 2
        return vals[0], idx[0]
    dev = vals[0].device
    av = torch.cat([v.to(dev) for v in vals], dim=1)        # (b, p·k)
    ai = torch.cat([i.to(dev) for i in idx], dim=1)
    v, pos = _top(av, k)
    return v, torch.gather(ai, 1, pos)


def _resolve_merge(merge: str, p: int) -> str:
    if merge not in ("auto", "tree", "gather"):
        raise ValueError(f"merge must be 'auto', 'tree' or 'gather', got "
                         f"{merge!r}")
    if merge == "tree" and p & (p - 1):
        raise ValueError(f"the pairwise tree merge needs a power-of-two "
                         f"mesh, got {p} shards — use merge='gather'")
    if merge == "auto":
        return "tree" if p & (p - 1) == 0 else "gather"
    return merge


def _tuned_chunk(m: int, kl: int, b: int, k: int, metric: str,
                 device: torch.device) -> int:
    """Measured streaming-tile search through kernels/autotune: the ladder
    clipped to m plus the hand default, so the tuned pick is never slower
    than DEFAULT_CHUNK (up to timer noise); results persist in the shared
    autotune cache keyed on the scan's shape and the device."""
    from repro_torch.kernels import autotune as _at
    m_eff = max(m, 1)
    default = min(DEFAULT_CHUNK, m_eff)
    cands = sorted({min(c, m_eff) for c in _CHUNK_CANDIDATES} | {default})
    if len(cands) == 1:
        return cands[0]
    key = (m, kl, b, k, metric)
    cached = _at.lookup("topk_chunk", key, device)
    if cached is not None and len(cached) == 1 \
            and isinstance(cached[0], int) and 1 <= cached[0] <= m_eff:
        return cached[0]

    def synth(shape, seed):
        return torch.from_numpy(np.random.RandomState(seed).rand(*shape)
                                .astype(np.float32)).to(device)

    args = functools.cache(lambda: (
        synth((m, kl), 0), torch.ones((m,), device=device),
        synth((b, kl), 1), torch.ones((b,), device=device)))

    def run(params):
        return _scan(*args(), k=k, metric=metric, chunk=params[0],
                     total_m=m)[0]

    (chosen,) = _at.tune("topk_chunk", key, [(c,) for c in cands], run,
                         device=device)
    return chosen


def topk_rows(W, queries, *, k: int = 10, gram=None, metric: str = "dot",
              chunk: int | None = DEFAULT_CHUNK, row_norms=None, mesh=None,
              merge: str = "auto", valid_rows: int | None = None):
    """Top-k rows of ``W`` (m, kl) for latent queries (b, kl), on W's
    device (a numpy W goes to ``cuda``, as every entry point).

    Returns ``(scores, indices)``, both (b, k) (fp32 and int64), scores
    descending per query.  ``gram`` switches on reconstruction-space
    scoring (pass the artifact's ``HHᵀ``); ``metric="cosine"`` normalises
    by both row and query norms in that space — pass the precomputed
    ``row_norms`` (m,) when W is fixed across queries (``TopK`` does).
    ``chunk`` bounds resident memory at b×chunk scores; ``chunk=None``
    autotunes it (measured, cached).

    ``mesh`` shards the scan: W (a ``serve.mesh.ShardedRows`` over that
    mesh, or a tensor split here) and its row norms row-wise over the
    mesh, each shard scanning its rows, the candidates merged (``merge``:
    "tree" on power-of-two meshes, "gather" otherwise, "auto" picks);
    results land on the mesh's first device.  ``valid_rows`` caps scoring
    at the first ``valid_rows`` rows (tail rows are sharding pad and never
    retrieved).
    """
    from repro_torch.serve.mesh import ShardedRows, mesh_devices
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    devs = None if mesh is None else mesh_devices(mesh)
    if isinstance(W, ShardedRows):
        if devs is None or W.mesh != mesh:
            raise ValueError("sharded W scores on its own mesh: pass it "
                             "as mesh=")
        shards = W.shards
    else:
        if not isinstance(W, torch.Tensor):
            W = to_torch(W, device=resolve_device(
                None if devs is None else devs[0]))
        shards = ((W,) if devs is None
                  else ShardedRows.split(W, mesh).shards)
    m, kl = W.shape
    dev = shards[0].device
    Q = to_torch(queries, device=dev)
    if Q.dim() == 1:
        Q = Q[None, :]
    if kl != Q.shape[1]:
        raise ValueError(f"W has latent dim {kl}, queries {Q.shape[1]}")
    m_valid = m if valid_rows is None else int(valid_rows)
    if k > m_valid:
        raise ValueError(f"k={k} exceeds the {m_valid} rows of W")
    use_gram = gram is not None
    G = (to_torch(gram, device=dev, dtype=torch.float32) if use_gram
         else torch.eye(kl, dtype=torch.float32, device=dev))
    Qf = Q.float()
    Qt = Qf @ G if use_gram else Qf            # transform queries once
    norms = [None] * len(shards)
    qnorm = None
    if metric == "cosine":
        if row_norms is None:
            norms = [_row_norms(s, G.to(s.device), use_gram=use_gram)
                     for s in shards]
        elif isinstance(row_norms, ShardedRows):
            norms = [n.reshape(-1) for n in row_norms.shards]
        else:
            rn = to_torch(row_norms, device=dev, dtype=torch.float32)
            if tuple(rn.shape) != (m,):
                raise ValueError(f"row_norms must be ({m},), got "
                                 f"{tuple(rn.shape)}")
            norms = ([rn] if devs is None else
                     [n.reshape(-1) for n in ShardedRows.split(
                         rn[:, None], mesh).shards])
        qsq = torch.sum(Qt * Qf, dim=1)
        qnorm = torch.clamp_min(torch.sqrt(torch.clamp_min(qsq, 0.0)), _EPS)
    mb = shards[0].shape[0]
    c = chunk if chunk is not None else _tuned_chunk(
        mb, kl, Q.shape[0], k, metric, dev)
    c = int(min(c, max(mb, 1)))
    if devs is None:
        return _scan(shards[0], norms[0], Qt, qnorm, k=k, metric=metric,
                     chunk=c, total_m=m_valid)
    vals, idx = [], []
    for s, (Ws, d) in enumerate(zip(shards, devs)):
        v, i = _scan(Ws, norms[s], Qt.to(d),
                     None if qnorm is None else qnorm.to(d), k=k,
                     metric=metric, chunk=c, total_m=m_valid,
                     offset=s * mb)
        vals.append(v)
        idx.append(i)
    return _merge(vals, idx, k=k, merge=_resolve_merge(merge, len(devs)))


class TopK:
    """Retrieval handle bound to one artifact: ``TopK(art).query(X, k=5)``
    scores against ``art.W`` with the artifact's Gram (reconstruction
    space), on the artifact's device, or sharded over ``mesh``.  What is
    fixed per artifact is computed here once — for cosine the row norms,
    with ``mesh=`` the row-sharded W (the sharded artifact's own, or split
    here) — so a query is the k-dim scores and the merge.  ``chunk=None``
    autotunes the streaming tile."""

    def __init__(self, artifact: FactorArtifact, *, metric: str = "cosine",
                 chunk: int | None = DEFAULT_CHUNK, mesh=None,
                 merge: str = "auto"):
        from repro_torch.serve.mesh import ShardedRows, mesh_devices
        if metric not in METRICS:
            raise ValueError(f"metric must be one of {METRICS}, got "
                             f"{metric!r}")
        self.metric, self.chunk = metric, chunk
        self.mesh, self.merge = mesh, merge
        self.valid_rows = artifact.shape[0]
        self.gram = artifact.gram.float()
        if mesh is None:
            self.W = artifact._unpadded_W().float()
            self.row_norms = (_row_norms(self.W, self.gram, use_gram=True)
                              if metric == "cosine" else None)
            return
        devs = mesh_devices(mesh)
        _resolve_merge(merge, len(devs))
        W = artifact.W
        if not (isinstance(W, ShardedRows) and artifact.mesh == mesh):
            W = ShardedRows.split(artifact._unpadded_W(), mesh)
        self.W = ShardedRows([s.float() for s in W.shards], mesh)
        self.row_norms = None
        if metric == "cosine":
            self.row_norms = ShardedRows(
                [_row_norms(s, self.gram.to(s.device), use_gram=True)[:, None]
                 for s in self.W.shards], mesh)

    def query(self, latent_codes, *, k: int = 10):
        t0 = _time.perf_counter()
        with _span("topk.query", k=k):
            out = topk_rows(self.W, latent_codes, k=k, gram=self.gram,
                            metric=self.metric, chunk=self.chunk,
                            row_norms=self.row_norms, mesh=self.mesh,
                            merge=self.merge, valid_rows=self.valid_rows)
        reg = _default_registry()
        reg.counter("serve_topk_queries_total",
                    help="Top-k retrieval calls").inc()
        reg.histogram("serve_topk_query_latency_s",
                      help="Top-k dispatch seconds per call").observe(
            _time.perf_counter() - t0)
        return out
