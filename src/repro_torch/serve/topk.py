"""Top-k retrieval over trained factors: the nearest rows of W to a query's
latent code, scored in the k-dim space.  Counterpart of
``repro/serve/topk.py``, single-device.

With the precomputed Gram ``G = HHᵀ`` the reconstruction-space score of
row i collapses to a k-dim form (the Gram trick),

    ⟨w_i H, x H⟩ = w_i G xᵀ,

so a query is transformed once (``q̃ = x G``) and every row score is a
k-length dot; ``gram=None`` scores directly in latent space.  W streams
in ``chunk``-row tiles while a running (b, k) top-k set is merged per tile
with ``torch.topk``, so no more than one (b, chunk) score block exists at a
time.  The score products are plain ``torch.matmul``, as the reference
leaves them to XLA outside any Pallas kernel.

The measured chunk autotuner (``chunk=None``) and sharded retrieval
(``mesh=``) are not ported yet (ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

import torch

from repro_torch.serve.artifact import FactorArtifact
from repro_torch.util.convert import to_torch
from repro_torch.util.device import resolve_device

_EPS = 1e-12

METRICS = ("dot", "cosine")

#: rows of W scored per streaming step
DEFAULT_CHUNK = 4096

_AUTOTUNE_TODO = ("chunk=None (the measured chunk autotuner) is not ported "
                  "yet (ROADMAP.md queue 1 item 10, with kernels/autotune)")
_MESH_TODO = ("sharded top-k (mesh=) is not ported yet (ROADMAP.md queue 1 "
              "item 10, mesh serving)")


def _row_norms(W: torch.Tensor, G: torch.Tensor, *,
               use_gram: bool) -> torch.Tensor:
    """‖w_i H‖ per row via the Gram (√(w_i G w_iᵀ)), or the latent ‖w_i‖:
    m·k² once per (W, G), which ``TopK`` keeps out of the request path."""
    Wf = W.float()
    base = (torch.sum((Wf @ G) * Wf, dim=1) if use_gram
            else torch.sum(Wf * Wf, dim=1))
    return torch.sqrt(torch.clamp_min(base, 0.0))


def _scan(W, Wn, Q, qnorm, *, k: int, metric: str, chunk: int,
          total_m: int):
    """The streaming chunk scan: a running (b, k) set merged per tile;
    rows at or past ``total_m`` score -inf."""
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
        gidx = torch.arange(start, start + C.shape[0], device=dev)
        if start + C.shape[0] > total_m:
            s = torch.where((gidx < total_m)[None, :], s,
                            torch.full_like(s, float("-inf")))
        cand_v = torch.cat([vals, s], dim=1)
        cand_i = torch.cat([idx, gidx[None, :].expand(b, -1)], dim=1)
        vals, pos = torch.topk(cand_v, k, dim=1)
        idx = torch.gather(cand_i, 1, pos)
    return vals, idx


def topk_rows(W, queries, *, k: int = 10, gram=None, metric: str = "dot",
              chunk: int | None = DEFAULT_CHUNK, row_norms=None, mesh=None,
              valid_rows: int | None = None):
    """Top-k rows of ``W`` (m, kl) for latent queries (b, kl), on W's
    device (a numpy W goes to ``cuda``, as every entry point).

    Returns ``(scores, indices)``, both (b, k) (fp32 and int64), scores
    descending per query.  ``gram`` switches on reconstruction-space
    scoring (pass the artifact's ``HHᵀ``); ``metric="cosine"`` normalises
    by both row and query norms in that space — pass the precomputed
    ``row_norms`` (m,) when W is fixed across queries (``TopK`` does).
    ``chunk`` bounds resident memory at b×chunk scores.  ``valid_rows``
    caps scoring at the first ``valid_rows`` rows.
    """
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    if chunk is None:
        raise NotImplementedError(_AUTOTUNE_TODO)
    if not isinstance(W, torch.Tensor):
        W = to_torch(W, device=resolve_device(None))
    Q = to_torch(queries, device=W.device)
    if Q.dim() == 1:
        Q = Q[None, :]
    if W.shape[1] != Q.shape[1]:
        raise ValueError(f"W has latent dim {W.shape[1]}, queries "
                         f"{Q.shape[1]}")
    m_valid = W.shape[0] if valid_rows is None else int(valid_rows)
    if k > m_valid:
        raise ValueError(f"k={k} exceeds the {m_valid} rows of W")
    use_gram = gram is not None
    G = (to_torch(gram, device=W.device, dtype=torch.float32) if use_gram
         else torch.eye(W.shape[1], dtype=torch.float32, device=W.device))
    Qf = Q.float()
    Qt = Qf @ G if use_gram else Qf            # transform queries once
    if metric == "cosine":
        if row_norms is None:
            row_norms = _row_norms(W, G, use_gram=use_gram)
        Wn = to_torch(row_norms, device=W.device, dtype=torch.float32)
        if tuple(Wn.shape) != (W.shape[0],):
            raise ValueError(f"row_norms must be ({W.shape[0]},), got "
                             f"{tuple(Wn.shape)}")
        qsq = torch.sum(Qt * Qf, dim=1)
        qnorm = torch.clamp_min(torch.sqrt(torch.clamp_min(qsq, 0.0)), _EPS)
    else:
        Wn = qnorm = None
    c = int(min(chunk, max(W.shape[0], 1)))
    return _scan(W, Wn, Qt, qnorm, k=k, metric=metric, chunk=c,
                 total_m=m_valid)


class TopK:
    """Retrieval handle bound to one artifact: ``TopK(art).query(X, k=5)``
    scores against ``art.W`` with the artifact's Gram (reconstruction
    space), on the artifact's device.  For cosine the (m,) row norms are
    computed once here, so a query is the k-dim scores and the merge."""

    def __init__(self, artifact: FactorArtifact, *, metric: str = "cosine",
                 chunk: int | None = DEFAULT_CHUNK, mesh=None):
        if mesh is not None:
            raise NotImplementedError(_MESH_TODO)
        if chunk is None:
            raise NotImplementedError(_AUTOTUNE_TODO)
        self.metric = metric
        self.chunk = chunk
        self.gram = artifact.gram.float()
        self.W = artifact.W.float()
        self.row_norms = (_row_norms(self.W, self.gram, use_gram=True)
                          if metric == "cosine" else None)

    def query(self, latent_codes, *, k: int = 10):
        return topk_rows(self.W, latent_codes, k=k, gram=self.gram,
                         metric=self.metric, chunk=self.chunk,
                         row_norms=self.row_norms)
