"""Recurrent sequence-mixing cells: RG-LRU (Griffin), mLSTM and sLSTM (xLSTM).
Counterpart of ``repro/models/recurrent.py``.

* **RG-LRU** — input-dependent diagonal linear recurrence
  ``h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t)``, over the sequence as
  a scan on the monoid ``(a₂,b₂)∘(a₁,b₁) = (a₁a₂, a₂b₁+b₂)`` in fp32.  The
  reference uses ``lax.associative_scan``, which PyTorch lacks; here it is a
  Hillis–Steele log-step scan (⌈log₂ S⌉ elementwise steps).  The products
  associate in another order, so the two agree to fp32 rounding, not bits.

* **mLSTM** — matrix-memory cell ``C_t = f_t C_{t-1} + i_t v_t k_tᵀ`` with
  exponential gating and max-state stabilisation (arXiv:2405.04517 App. A).
  Prefill runs the *chunked parallel form* (intra-chunk L×L products and a
  loop over chunks carrying (C, n, m)); decode is the O(1) recurrent step.

* **sLSTM** — scalar-memory cell with recurrent gate mixing (R·h_{t-1},
  block-diagonal per head): inherently sequential, a loop over time steps.

All recurrences compute in fp32 regardless of activation dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import KeyGen, dense_init, normal, uniform


# ============================================================= temporal conv

def init_conv1d(seed, dim, width, dtype, *, device):
    return {"w": (normal(seed, (width, dim), device=device)
                  * width ** -0.5).to(dtype),
            "b": torch.zeros((dim,), dtype=dtype, device=device)}


def conv1d_causal(p, x, state=None):
    """Depthwise causal conv.  x (B,S,D).  state (B,width-1,D) for decode.

    Returns (y, new_state)."""
    width = p["w"].shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)                  # (B, S+w-1, D)
    w = p["w"].to(x.dtype)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(width))
    y = y + p["b"].to(x.dtype)
    new_state = xp[:, -(width - 1):, :] if width > 1 else state
    return y, new_state


# =================================================================== RG-LRU

def init_rglru(seed, dim, dtype, *, device):
    kg = KeyGen(seed)
    # Λ init so a = exp(-c·softplus(Λ)) lands in [0.9, 0.999] (Griffin §2.4).
    u = uniform(kg(), (dim,), 0.9, 0.999, device=device)
    lam = torch.log(torch.expm1(-torch.log(u) / 8.0))  # softplus⁻¹
    return {
        "lam": lam.float(),
        "wa": dense_init(kg(), dim, dim, dtype, device=device),
        "ba": torch.zeros((dim,), dtype=dtype, device=device),
        "wx": dense_init(kg(), dim, dim, dtype, device=device),
        "bx": torch.zeros((dim,), dtype=dtype, device=device),
    }


def _rglru_coeffs(p, x, c: float, xg=None):
    """(a, b) of the recurrence on ``x``'s channels; the gates read ``xg``
    (default ``x``): under tensor parallelism ``x`` is the rank's channels
    and ``xg`` all of them, ``p``'s gate columns and Λ the rank's."""
    x32 = x.float()
    g32 = x32 if xg is None else xg.float()
    r = torch.sigmoid(g32 @ p["wa"].float() + p["ba"].float())
    i = torch.sigmoid(g32 @ p["wx"].float() + p["bx"].float())
    log_a = -c * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    # β = √(1−a²) computed stably via expm1: 1−a² = −expm1(2·log_a)
    beta = torch.sqrt(torch.clamp_min(-torch.expm1(2.0 * log_a), 1e-12))
    b = beta * (i * x32)
    return a, b


def linear_scan(a, b):
    """Inclusive scan of h_t = a_t·h_{t-1} + b_t (h_{-1} = 0) over axis 1,
    Hillis–Steele: after the step of stride d each position holds the
    composition of its last 2d elements."""
    S = a.shape[1]
    d = 1
    while d < S:
        # (a, b)[t] ∘= (a, b)[t-d]: b_t += a_t·b_{t-d}, a_t *= a_{t-d}
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def rglru_scan(p, x, *, c: float = 8.0, h0=None, xg=None):
    """x (B,S,D) -> (y (B,S,D), h_last (B,D)); ``xg`` what the gates read
    (``_rglru_coeffs``)."""
    a, b = _rglru_coeffs(p, x, c, xg)
    if h0 is not None:
        # Fold the carried state into the first step's offset.
        b = b.clone()
        b[:, 0, :] += a[:, 0, :] * h0.float()
    _, h = linear_scan(a, b)                          # h_t given h_{-1}=0
    return h.to(x.dtype), h[:, -1, :]


def rglru_step(p, x_t, h, *, c: float = 8.0, xg_t=None):
    """One decode step.  x_t (B,D), h (B,D) fp32 -> (y_t, h_new)."""
    a, b = _rglru_coeffs(p, x_t[:, None, :], c,
                         None if xg_t is None else xg_t[:, None, :])
    h_new = a[:, 0] * h + b[:, 0]
    return h_new.to(x_t.dtype), h_new


# ==================================================================== mLSTM

def init_mlstm_cell(seed, d_inner, n_heads, dtype, *, device):
    kg = KeyGen(seed)
    hd = d_inner // n_heads
    f32 = torch.float32
    return {
        "wq": dense_init(kg(), d_inner, d_inner, dtype, device=device),
        "wk": dense_init(kg(), d_inner, d_inner, dtype, device=device),
        "wv": dense_init(kg(), d_inner, d_inner, dtype, device=device),
        "wi": dense_init(kg(), d_inner, n_heads, dtype, scale=0.02,
                         device=device),
        "bi": torch.zeros((n_heads,), dtype=f32, device=device),
        "wf": dense_init(kg(), d_inner, n_heads, dtype, scale=0.02,
                         device=device),
        "bf": torch.linspace(3.0, 6.0, n_heads, dtype=f32, device=device),
        "ogate_scale": torch.ones((n_heads, hd), dtype=f32, device=device),
    }


def _no_heads(x, p, state):
    """A cell of no heads (a rank of "model" that holds none): its empty
    output and the state as it is.  The output still reads ``x`` and
    every leaf of ``p`` (their empty parts), so their zero gradients flow
    back through the collectives that made them, as on the ranks with
    heads."""
    y = x[..., :0]
    for t in p.values():
        y = y + t.sum().to(y.dtype)
    return y, state


def _mlstm_qkvg(p, x, n_heads):
    """q, k, v, ĩ, f̃ of ``n_heads`` heads (``p``'s columns: all heads, or
    a rank's) from the cell input ``x`` (B,S,Din)."""
    B, S, _ = x.shape
    hd = p["wq"].shape[-1] // n_heads
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, n_heads, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, n_heads, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, n_heads, hd)
    x32 = x.float()
    ig = x32 @ p["wi"].float() + p["bi"]                 # (B,S,H)
    fg = x32 @ p["wf"].float() + p["bf"]                 # (B,S,H)

    def tr(t):                                           # heads-major fp32
        return t.float().transpose(1, 2)
    return tr(q) * hd ** -0.5, tr(k), tr(v), \
        ig.transpose(1, 2), fg.transpose(1, 2)


def mlstm_chunked(p, x, n_heads: int, chunk: int = 256, state=None):
    """Chunked-parallel mLSTM.  x (B,S,Din) -> (y (B,S,H·dh), state): the
    ``n_heads`` heads of ``p``'s q/k/v columns (all of them, or a rank's
    under tensor parallelism, which reads the whole ``x``).

    state = (C (B,H,dh,dh), n (B,H,dh), m (B,H)).
    """
    if n_heads == 0:
        return _no_heads(x, p, state)
    B, S, _ = x.shape
    H = n_heads
    Din = p["wq"].shape[-1]
    hd = Din // H
    q, k, v, ig, fg = _mlstm_qkvg(p, x, H)            # (B,H,S,dh) / (B,H,S)
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        # State-safe padding: ĩ=-inf (no input contribution), f̃=+inf (no
        # decay), so padded steps leave the carried state untouched; their
        # outputs are sliced off below.
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        ig = F.pad(ig, (0, pad), value=-1e30)
        fg = F.pad(fg, (0, pad), value=1e30)
    Sp = S + pad
    nchunks = Sp // L

    if state is None:
        C = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        m = torch.full((B, H), -1e30, dtype=torch.float32, device=x.device)
    else:
        C, n, m = state
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))

    hs = []
    for j in range(nchunks):
        # Derivation: with b_τ = Σ_{s≤τ} log f_s (inclusive cumsum), the true
        # (unstabilised) state satisfies
        #   C_τ = e^{b_τ} C_chunk0 + Σ_{s≤τ} e^{b_τ − b_s + ĩ_s} k_s v_sᵀ
        # (the input at s is NOT decayed by f_s itself).  The carried state
        # (C, n) is stabilised by e^{−m}; per-token stabiliser
        #   m_τ = b_τ + max(m_prev, max_{s≤τ}(ĩ_s − b_s)).
        sl = slice(j * L, (j + 1) * L)
        qc, kc, vc, ic, fc = q[:, :, sl], k[:, :, sl], v[:, :, sl], \
            ig[:, :, sl], fg[:, :, sl]
        lf = F.logsigmoid(fc)                         # log forget gates
        bcum = torch.cumsum(lf, dim=-1)               # b_τ, (B,H,L)
        btot = bcum[..., -1]
        src = ic - bcum                               # ĩ_s − b_s
        m_intra = torch.cummax(src, dim=-1).values
        m_tok = bcum + torch.maximum(m[..., None], m_intra)
        # inter-chunk: e^{b_τ + m_prev − m_τ} (qᵀ C)
        w_inter = torch.exp(bcum + m[..., None] - m_tok)   # (B,H,L)
        h_inter = torch.einsum("bhld,bhde->bhle", qc, C) * w_inter[..., None]
        l_inter = torch.einsum("bhld,bhd->bhl", qc, n) * w_inter
        # intra-chunk: D_τs = e^{b_τ + (ĩ_s − b_s) − m_τ} for s ≤ τ
        logD = bcum[..., :, None] + src[..., None, :] - m_tok[..., :, None]
        Dm = torch.where(tri, torch.exp(logD), 0.0)
        scores = torch.einsum("bhld,bhsd->bhls", qc, kc) * Dm
        h_intra = torch.einsum("bhls,bhsd->bhld", scores, vc)
        l_intra = torch.sum(scores, dim=-1)
        denom = torch.maximum(torch.abs(l_inter + l_intra), torch.exp(-m_tok))
        hs.append((h_inter + h_intra) / denom[..., None])
        # state propagation to chunk end: m_next = b_L + max(m_prev, max src)
        M = torch.maximum(m, src.amax(dim=-1))
        wC_old = torch.exp(m - M)                         # (B,H)
        w_src = torch.exp(src - M[..., None])             # (B,H,L)
        C = C * wC_old[..., None, None] + torch.einsum(
            "bhsd,bhse->bhde", kc * w_src[..., None], vc)
        n = n * wC_old[..., None] + torch.einsum("bhs,bhsd->bhd", w_src, kc)
        m = btot + M
    # hs: nchunks × (B, H, L, hd) -> (B, S, Din)
    y = torch.cat(hs, dim=2).transpose(1, 2).reshape(B, Sp, Din)[:, :S]
    return y.to(x.dtype), (C, n, m)


def mlstm_step(p, x_t, n_heads: int, state):
    """One decode step.  x_t (B,Din) -> (y_t (B,H·dh), state)."""
    if n_heads == 0:
        return _no_heads(x_t, p, state)
    B = x_t.shape[0]
    q, k, v, ig, fg = _mlstm_qkvg(p, x_t[:, None, :], n_heads)
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]       # (B,H,hd)
    ig, fg = ig[:, :, 0], fg[:, :, 0]                  # (B,H)
    C, n, m = state
    lf = F.logsigmoid(fg)
    m_new = torch.maximum(lf + m, ig)
    fprime = torch.exp(lf + m - m_new)
    iprime = torch.exp(ig - m_new)
    C = C * fprime[..., None, None] + iprime[..., None, None] \
        * (k[..., :, None] * v[..., None, :])
    n = n * fprime[..., None] + iprime[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", q, n)),
                        torch.exp(-m_new))
    h = num / den[..., None]
    y = h.reshape(B, -1)
    return y.to(x_t.dtype), (C, n, m_new)


# ==================================================================== sLSTM

def init_slstm_cell(seed, d_inner, n_heads, dtype, *, device):
    kg = KeyGen(seed)
    hd = d_inner // n_heads
    f32 = torch.float32

    def rinit():
        return normal(kg(), (n_heads, hd, hd), device=device) * hd ** -0.5
    return {
        "wz": dense_init(kg(), d_inner, d_inner, dtype, device=device),
        "wi": dense_init(kg(), d_inner, d_inner, dtype, device=device),
        "wf": dense_init(kg(), d_inner, d_inner, dtype, device=device),
        "wo": dense_init(kg(), d_inner, d_inner, dtype, device=device),
        "rz": rinit(), "ri": rinit(), "rf": rinit(), "ro": rinit(),
        "bz": torch.zeros((d_inner,), dtype=f32, device=device),
        "bi": torch.zeros((d_inner,), dtype=f32, device=device),
        "bf": torch.linspace(3.0, 6.0, n_heads, dtype=f32,
                             device=device).repeat_interleave(hd),
        "bo": torch.zeros((d_inner,), dtype=f32, device=device),
    }


def slstm_scan(p, x, n_heads: int, state=None):
    """x (B,S,Din) -> (y (B,S,H·dh), state); a loop over time (see module
    doc).  ``n_heads`` heads of ``p``'s gate columns and recurrent blocks:
    all, or a rank's under tensor parallelism (which reads the whole
    ``x``)."""
    if n_heads == 0:
        return _no_heads(x, p, state)
    B, S, _ = x.shape
    H = n_heads
    Din = p["wz"].shape[-1]
    hd = Din // H
    x32 = x.float()
    zx = x32 @ p["wz"].float() + p["bz"]
    ix = x32 @ p["wi"].float() + p["bi"]
    fx = x32 @ p["wf"].float() + p["bf"]
    ox = x32 @ p["wo"].float() + p["bo"]
    pre = torch.stack([zx, ix, fx, ox], 0).reshape(4, B, S, H, hd) \
        .permute(2, 0, 1, 3, 4)                       # (S,4,B,H,hd)

    if state is None:
        zeros = torch.zeros((B, H, hd), dtype=torch.float32, device=x.device)
        state = (zeros, zeros + 1e-6, zeros, zeros - 1e30)  # c, n, h, m
    # (4,H,hd,hd) in fp32 whatever the parameters' dtype (the reference's
    # einsum promotes a bf16 R against the fp32 state)
    R = torch.stack([p["rz"], p["ri"], p["rf"], p["ro"]], 0).float()

    c, n, h, m = state
    hs = []
    for t in range(S):
        inp = pre[t]
        rec = torch.einsum("bhd,ghde->gbhe", h, R)    # (4,B,H,hd)
        z = torch.tanh(inp[0] + rec[0])
        ilog = inp[1] + rec[1]
        flog = F.logsigmoid(inp[2] + rec[2])
        o = torch.sigmoid(inp[3] + rec[3])
        m_new = torch.maximum(flog + m, ilog)
        fp = torch.exp(flog + m - m_new)
        ip = torch.exp(ilog - m_new)
        c = fp * c + ip * z
        n = fp * n + ip
        h = o * (c / torch.clamp_min(n, 1e-6))
        m = m_new
        hs.append(h)
    y = torch.stack(hs, 1).reshape(B, S, Din)
    return y.to(x.dtype), (c, n, h, m)


def slstm_step(p, x_t, n_heads: int, state):
    y, state = slstm_scan(p, x_t[:, None, :], n_heads, state)
    return y[:, 0, :], state
