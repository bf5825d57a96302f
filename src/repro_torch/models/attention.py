"""Attention: GQA/MQA/MHA, causal/bidirectional/local-window/cross, with a
memory-efficient blockwise (flash-style) path in plain PyTorch.
Counterpart of ``repro/models/attention.py``.

The reference computes attention in plain JAX, not in a Pallas kernel (the
paper under reproduction contributes no attention kernel), and so does the
port: the chunk loops below are the reference's Rabe–Staats online softmax
(no S×S score matrix at long S) with its local-window band slicing (only
the in-band KV per query chunk) and its static above-diagonal skipping
(``causal_skip``).  ``F.scaled_dot_product_attention`` is not used: it
takes neither the soft cap nor the band, and would hide the chunked work.

Conventions: q (B, Sq, H, hd); k/v (B, Skv, KH, hd); GQA groups G = H // KH
(``_groups``).
All softmax math in fp32.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.models.common import KeyGen, dense_init

NEG_INF = -1e30


# ------------------------------------------------------------------ params

def init_attn(seed, cfg, *, cross: bool = False, device):
    kg = KeyGen(seed)
    D, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    pdt = cfg.param_dtype_torch
    p = {
        "wq": dense_init(kg(), D, H * hd, pdt, device=device),
        "wk": dense_init(kg(), D, KH * hd, pdt, device=device),
        "wv": dense_init(kg(), D, KH * hd, pdt, device=device),
        "wo": dense_init(kg(), H * hd, D, pdt, device=device,
                         scale=(H * hd) ** -0.5 / math.sqrt(2 * cfg.n_layers)),
    }
    if cfg.qkv_bias:
        for nm, dim in (("bq", H * hd), ("bk", KH * hd), ("bv", KH * hd)):
            p[nm] = torch.zeros((dim,), dtype=pdt, device=device)
    if cfg.attn_out_bias:
        p["bo"] = torch.zeros((D,), dtype=pdt, device=device)
    if cross:                                         # tanh-gated residual
        p["gate"] = torch.zeros((), dtype=pdt, device=device)
    return p


def proj(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def head_part(t, heads: tuple, unit: int, n_heads: int, dim: int = -1):
    """Heads ``heads`` = (h0, h1) of a leaf laid out head by head along
    ``dim``, ``unit`` entries a head: a view of their part of the whole
    leaf (``n_heads`` · ``unit`` long), or ``t`` itself where it holds
    their part only (a shard: heads that divide "model" arrive split as
    stored)."""
    h0, h1 = heads
    size = t.shape[dim]
    if size == (h1 - h0) * unit:
        return t
    if size != n_heads * unit:
        raise ValueError(f"a leaf of {size} along dim {dim} is neither "
                         f"{n_heads} heads of {unit} nor heads {h0}…{h1}")
    return t.narrow(dim, h0 * unit, (h1 - h0) * unit)


def kv_heads_of(q0: int, n_q: int, group: int) -> tuple:
    """KV heads [lo, hi) that query heads q0 … q0 + n_q − 1 read, GQA
    groups of ``group`` query heads a KV head (none for no query
    heads)."""
    if n_q == 0:
        return q0 // group, q0 // group
    return q0 // group, (q0 + n_q - 1) // group + 1


def kv_for_heads(k, q0: int, n_q: int, group: int, k0: int):
    """KV heads ``k0`` … (B, S, n, hd) laid out for query heads q0 …
    q0 + n_q − 1: as they are where local query head i reads local KV head
    i // (n_q / n) (the attention's own grouping), else one KV head per
    query head (an odd count of query heads over a GQA group, whose first
    and last groups the neighbouring ranks share)."""
    n = k.shape[2]
    if n_q == 0:
        return k
    want = [(q0 + i) // group - k0 for i in range(n_q)]
    if n_q % n == 0 and want == [i // (n_q // n) for i in range(n_q)]:
        return k
    return k[:, :, want]


def qkv(p, x, cfg, ctx=None, *, rotate=None, whole_kv=False, heads=None,
        group=None):
    """Project to per-head (q, k, v, k_all, v_all), k/v from ``ctx`` when
    cross-attending.  The query heads are ``heads`` = (h0, h1) (all of
    them where None), of ``wq``'s columns: its heads' part of a whole
    ``wq``, or the rank's shard over ``group`` ("model").  k/v are the KV
    heads those query heads read, laid out for the attention's grouping
    (``kv_for_heads``): the shard's own KV heads when they split with the
    query heads, else the ones it needs of the whole KV projection.  With
    ``whole_kv``, ``k_all``/``v_all`` hold every KV head (what a cache
    holds; None otherwise).  ``rotate`` (rope) applies to q and k."""
    rotate = rotate or (lambda t: t)
    src = x if ctx is None else ctx
    H, KH, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    h0, h1 = heads or (0, H)
    Hl, KHl = h1 - h0, p["wk"].shape[-1] // hd
    B, Sq, _ = x.shape
    Skv = src.shape[1]
    bq = p.get("bq")
    q = rotate(proj(x, head_part(p["wq"], (h0, h1), hd, H),
                    None if bq is None else head_part(bq, (h0, h1), hd, H))
               .reshape(B, Sq, Hl, hd))
    if Hl == H or KHl < KH:
        # a whole layer, or KV heads split with the query heads
        k = rotate(proj(src, p["wk"], p.get("bk")).reshape(B, Skv, KHl, hd))
        v = proj(src, p["wv"], p.get("bv")).reshape(B, Skv, KHl, hd)
        if not whole_kv:
            return q, k, v, None, None
        if KHl == KH:
            return q, k, v, k, v
        return (q, k, v, tp_lib.all_gather(k, group, 2),
                tp_lib.all_gather(v, group, 2))
    # query heads split, KV heads whole: the ones this rank's heads read
    k0, k1 = kv_heads_of(h0, Hl, H // KH)
    k_all = v_all = None
    if whole_kv:
        k_all = rotate(proj(src, p["wk"], p.get("bk")).reshape(B, Skv, KH,
                                                                hd))
        v_all = proj(src, p["wv"], p.get("bv")).reshape(B, Skv, KH, hd)
        k, v = k_all[:, :, k0:k1], v_all[:, :, k0:k1]
    else:
        cols = slice(k0 * hd, k1 * hd)
        bk, bv = p.get("bk"), p.get("bv")
        k = rotate(proj(src, p["wk"][:, cols],
                        None if bk is None else bk[cols])
                   .reshape(B, Skv, k1 - k0, hd))
        v = proj(src, p["wv"][:, cols], None if bv is None else bv[cols]) \
            .reshape(B, Skv, k1 - k0, hd)
    return (q, kv_for_heads(k, h0, Hl, H // KH, k0),
            kv_for_heads(v, h0, Hl, H // KH, k0), k_all, v_all)


# ---------------------------------------------------------------- core math

def _groups(H: int, KH: int) -> int:
    """Query heads a KV head: H // KH; 1 for no heads (a rank of "model"
    that holds none runs the same ops on empty tensors, so every leaf and
    input it was given is read and its gradient's collectives run as on
    the other ranks)."""
    return H // KH if KH else 1


def _scores_mask(qpos, kpos, *, causal: bool, window: int):
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        m &= qpos[:, None] - kpos[None, :] < window
    return m


def _attend_chunk(q, k, v, mask, softcap: float):
    """q (B,C,KH,G,hd) × k (B,L,KH,hd) -> (scores-softmax) @ v, unnormalised.

    Returns (numerator (B,C,KH,G,hd), rowmax (B,C,KH,G), rowsum (B,C,KH,G)).
    """
    hd = q.shape[-1]
    s = torch.einsum("bcigh,blih->bcigl", q.float(), k.float()) / math.sqrt(hd)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    num = torch.einsum("bcigl,blih->bcigh", p, v.float())
    return num, m, l


def _online_merge(acc, m_run, l_run, num, m, l):
    """Fold one chunk's (num, m, l) into the running softmax state."""
    m_new = torch.maximum(m_run, m)
    scale_old = torch.exp(m_run - m_new)
    scale_new = torch.exp(m - m_new)
    acc = acc * scale_old[..., None] + num * scale_new[..., None]
    l_run = l_run * scale_old + l * scale_new
    return acc, m_new, l_run


def _running_state(q):
    """Zero accumulator, −inf row max and zero row sum for q (B,C,KH,G,hd)."""
    B, C, KH, G, hd = q.shape
    acc = torch.zeros((B, C, KH, G, hd), dtype=torch.float32, device=q.device)
    m = torch.full((B, C, KH, G), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, C, KH, G), dtype=torch.float32, device=q.device)
    return acc, m, l


def blockwise_attention(q, k, v, *, causal: bool, window: int = 0,
                        q_chunk: int = 1024, kv_chunk: int = 1024,
                        q_offset: int = 0, kv_valid: int | None = None,
                        softcap: float = 0.0, causal_skip: bool = False,
                        unroll_limit: int = 32):
    """Online-softmax attention.  q (B,Sq,H,hd), k/v (B,Skv,KH,hd).

    ``kv_valid``: optional count of valid kv positions (decode).
    ``q_offset``: absolute position of q[0] (decode/chunked prefill).
    ``causal_skip``: q chunk i visits only kv chunks at or below the
    diagonal, where the default visits every chunk and masks.
    """
    B, Sq, H, hd = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = _groups(H, KH)
    q = q.reshape(B, Sq, KH, G, hd)
    dev = q.device

    q_chunk = min(q_chunk, Sq) if q_chunk else Sq
    kv_chunk = min(kv_chunk, Skv) if kv_chunk else Skv
    n_q, n_kv = Sq // q_chunk, Skv // kv_chunk
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError(f"blockwise_attention: Sq = {Sq} and Skv = {Skv} "
                         f"must be multiples of their chunks {q_chunk} and "
                         f"{kv_chunk}")

    if causal_skip and causal and window == 0 and Skv == Sq \
            and 1 < n_q <= unroll_limit and kv_valid is None:
        return _causal_skip_attention(q, k, v, q_chunk=q_chunk,
                                      kv_chunk=kv_chunk, q_offset=q_offset,
                                      softcap=softcap).reshape(B, Sq, H, hd)

    def per_q_chunk(qi, qc):
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)

        if window > 0 and Skv == Sq and n_kv > 1:
            # Local attention: slice only the in-band KV (length W + C).
            band = ((window + q_chunk + kv_chunk - 1) // kv_chunk) * kv_chunk
            band = min(band, Skv)
            start = min(max(qi * q_chunk + q_chunk - band, 0), Skv - band)
            kc, vc = k[:, start:start + band], v[:, start:start + band]
            kpos = start + torch.arange(band, device=dev)
            mask = _scores_mask(qpos, kpos, causal=causal, window=window)
            num, m, l = _attend_chunk(qc, kc, vc, mask, softcap)
            return (num / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)

        acc, m_run, l_run = _running_state(qc)
        for kj in range(n_kv):
            kc = k[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            vc = v[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            kpos = kj * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = _scores_mask(qpos, kpos, causal=causal, window=window)
            if kv_valid is not None:
                mask &= (kpos < kv_valid)[None, :]
            num, m, l = _attend_chunk(qc, kc, vc, mask, softcap)
            acc, m_run, l_run = _online_merge(acc, m_run, l_run, num, m, l)
        return (acc / torch.clamp_min(l_run, 1e-30)[..., None]).to(q.dtype)

    out = torch.cat([per_q_chunk(qi, q[:, qi * q_chunk:(qi + 1) * q_chunk])
                     for qi in range(n_q)], dim=1)
    return out.reshape(B, Sq, H, hd)


def _causal_skip_attention(q, k, v, *, q_chunk, kv_chunk, q_offset, softcap):
    """Causal blockwise attention whose q chunk i visits only kv chunks
    0..ceil(((i+1)·qc)/kc)−1: above-diagonal work is never done."""
    B, Sq, KH, G, hd = q.shape
    n_q = Sq // q_chunk
    dev = q.device
    outs = []
    for qi in range(n_q):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        qpos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        hi = min(((qi + 1) * q_chunk + kv_chunk - 1) // kv_chunk,
                 k.shape[1] // kv_chunk)
        acc, m_run, l_run = _running_state(qc)
        for kj in range(hi):
            kc = k[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            vc = v[:, kj * kv_chunk:(kj + 1) * kv_chunk]
            kpos = kj * kv_chunk + torch.arange(kc.shape[1], device=dev)
            mask = _scores_mask(qpos, kpos, causal=True, window=0)
            num, m, l = _attend_chunk(qc, kc, vc, mask, softcap)
            acc, m_run, l_run = _online_merge(acc, m_run, l_run, num, m, l)
        outs.append((acc / torch.clamp_min(l_run, 1e-30)[..., None])
                    .to(q.dtype))
    return torch.cat(outs, dim=1)


def dense_attention(q, k, v, *, causal: bool, window: int = 0,
                    q_offset: int = 0, kv_valid: int | None = None,
                    softcap: float = 0.0):
    """Plain einsum attention (small S / decode)."""
    B, Sq, H, hd = q.shape
    KH = k.shape[2]
    G = _groups(H, KH)
    q = q.reshape(B, Sq, KH, G, hd)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = _scores_mask(qpos, kpos, causal=causal, window=window)
    if kv_valid is not None:
        mask &= (kpos < kv_valid)[None, :]
    num, m, l = _attend_chunk(q, k, v, mask, softcap)
    out = (num / torch.clamp_min(l, 1e-30)[..., None]).to(v.dtype)
    return out.reshape(B, Sq, H, hd)


def merged_decode(q, k, v, *, kv_valid, softcap: float, group):
    """Decode attention over this rank's slice of the KV length, merged
    over ``group``: each rank's partial softmax state (numerator, row max,
    row sum) of ``_attend_chunk``, rescaled to the group's max (a max
    all-reduce) and summed (a sum all-reduce), the ``_online_merge``
    arithmetic over ranks.  ``kv_valid``: this slice's valid slots (None:
    all).  q (B, Sq, H, hd) whole over heads; returns (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    KH = k.shape[2]
    qr = q.reshape(B, Sq, KH, H // KH, hd)
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if kv_valid is not None:
        mask &= (kpos < kv_valid)[None, :]
    num, m, l = _attend_chunk(qr, k, v, mask, softcap)
    scale = torch.exp(m - tp_lib.all_max(m, group))
    # the numerator and the row sum summed by one all-reduce
    both = tp_lib.all_sum(torch.cat([num * scale[..., None],
                                     (l * scale)[..., None]], -1), group)
    num, l = both[..., :-1], both[..., -1]
    out = (num / torch.clamp_min(l, 1e-30)[..., None]).to(v.dtype)
    return out.reshape(B, Sq, H, hd)
