"""Pattern-based transformer stack covering all assigned architectures.
Counterpart of ``repro/models/transformer.py``.

A model is a cycled ``layer_pattern`` of block kinds over ``n_layers``
(+ an optional encoder stack for enc-dec models):

  attn        GQA/MQA/MHA self-attention + FFN        (dense/MoE archs)
  local_attn  windowed self-attention + FFN           (recurrentgemma)
  xattn       tanh-gated cross-attention + gated FFN  (llama-3.2 vision)
  attn_cross  self-attn + cross-attn + FFN            (whisper decoder)
  enc_attn    bidirectional self-attention + FFN      (whisper encoder)
  rglru       Griffin recurrent block + FFN           (recurrentgemma)
  mlstm       xLSTM matrix-memory block (self-contained projections)
  slstm       xLSTM scalar-memory block + GeGLU FFN

Each block kind is an ``nn.Module`` (a ``ParamTree`` of the reference's
parameter dict plus a ``forward``); the functional ``apply_*`` bodies take
either the module or a plain dict.  The reference stacks each pattern
position's parameters over groups and runs the stack as one ``lax.scan``;
here the stack is a loop over the layer modules, and layer ℓ is group
g = ℓ // period at position i = ℓ % period (``dec.groups.p{i}.{g}``), then
the tail (``dec.tail.{t}``).  Under ``cfg.remat`` a training forward
runs each layer group (one pass over the pattern) under
``torch.utils.checkpoint`` (non-reentrant), the counterpart of
``jax.checkpoint`` on the reference's scan body: its activations are
recomputed in the backward pass.  ``remat_policy="dots"`` keeps the matrix
products' outputs (selective activation checkpointing, the reference's
``dots_saveable``); the tail layers run without remat, as the reference's
unrolled tail does.

Every block supports three modes sharing parameters:
  train/prefill: full-sequence; prefill fills the decode caches;
  decode:        x is (B, 1, D) + per-block cache (KV ring buffers for
                 local attention, constant-size recurrent states).

Caches are a list with one dict of preallocated tensors per layer
(``init_stack_cache``), written in place: prefill copies into them and a
decode step writes its K/V at its slot (the reference returns a new pytree,
which XLA updates in place under donation).  A local-attention ring holds
position t in slot t mod W from the start: prefill rotates the last W keys
into phase, where the reference writes them to slots 0..W−1, which agrees
with its decode only when the prompt length is a multiple of W.

On a ``Runtime`` over a mesh with a "model" dim the layers run
tensor-parallel over it (the reference's GSPMD program; Megatron-LM's
layout): attention on the rank's whole query heads (column-parallel
q/k/v, row-parallel output, all-reduced or, under ``seq_parallel``,
reduce-scattered to the rank's slice of the sequence; ``Runtime.heads``:
H/tp where the heads divide and the parameters arrive split, else ⌈H/tp⌉
or ⌊H/tp⌋, none where H < tp, taken from parameters gathered whole), FFNs
on its columns where the parameters arrive split (``sharding.
compute_spec``; elsewhere an FFN runs whole on every rank).  The
recurrent mixers split too: an RG-LRU over its channels (the gates read
all of them, an all-gather), an mLSTM or sLSTM cell over the rank's whole
heads, as attention.  A rank without heads runs the same ops on empty
tensors, so its collectives are the other ranks'.  A decode cache
holds the rank's slice of the KV length (``KVShard``): decode attends over
it and merges the partial softmax states over the group; only the rank
holding a slot writes it.  A recurrent cache holds the rank's channels or
heads.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.distributed.sharding import head_range
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import recurrent as rec_lib
from repro_torch.models.common import (KeyGen, ParamTree, apply_norm,
                                       dense_init, gelu, init_norm, rope,
                                       silu)


# ----------------------------------------------------------- runtime context

#: the mesh dim the layers run tensor-parallel over (the sharding rules'
#: "model", which ``train.steps`` gathers and reduce-scatters around)
TP_AXIS = "model"


class Runtime:
    """Mesh context for in-model parallel decisions.  ``mesh`` is a
    ``DeviceMesh`` with named dims (None: one device).  The model runs on
    each rank's own shard of the batch (``train.steps``): ``data_axes`` are
    the mesh dims the batch is split over.  Over ``TP_AXIS`` ("model") the
    layers run tensor-parallel, as the reference's GSPMD program does: a
    layer whose parameters arrive as this rank's shard (its heads, FFN
    columns or vocabulary rows; ``distributed.sharding.compute_spec``)
    computes its part and sums or gathers over the group; attention and
    the xLSTM cells compute the rank's whole heads (``heads``) also from
    parameters that arrive whole; any other layer whose parameters arrive
    whole computes the whole layer on every rank.  The
    residual stream between the layers is whole over "model" or, under
    ``seq_parallel``, the rank's slice of the sequence (the ``act_btd``
    constraint of ``sharding.make_constraint_fn``, which ``shard``
    applies).  A mesh with an ``ep_axis`` dim runs the MoE layers
    expert-parallel over it (``moe.moe_ep``).  ``param_fn`` makes of a
    block the parameters it computes with (the sharded steps gather the
    shards there).  Without a "model" dim of more than one rank every
    collective here is the identity."""

    def __init__(self, mesh=None, data_axes=("pod", "data"), ep_axis="model",
                 param_fn=None, *, seq_parallel=False):
        names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
        self.mesh = mesh
        self.data_axes = tuple(a for a in data_axes if a in names)
        self.ep_axis = ep_axis if ep_axis in names else None
        self.param_fn = param_fn
        self.seq_parallel = seq_parallel
        self.group, self.tp, self.tp_rank = None, 1, 0
        self._constraint = None
        if TP_AXIS in names:
            from repro_torch.distributed.sharding import make_constraint_fn
            self.group = mesh.get_group(TP_AXIS)
            self.tp = mesh.size(names.index(TP_AXIS))
            self.tp_rank = mesh.get_local_rank(TP_AXIS)
            self._constraint = make_constraint_fn(
                mesh, tp_axis=TP_AXIS, seq_parallel=seq_parallel)

    def replace(self, **kw) -> "Runtime":
        """A copy with the given fields changed."""
        args = dict(data_axes=self.data_axes, ep_axis=self.ep_axis or "",
                    param_fn=self.param_fn, seq_parallel=self.seq_parallel)
        args.update(kw)
        return Runtime(self.mesh, args.pop("data_axes"), args.pop("ep_axis"),
                       args.pop("param_fn"), **args)

    @property
    def sp(self) -> bool:
        """Sequence parallelism on: the residual stream is the rank's
        slice of the sequence."""
        return self.seq_parallel and self.tp > 1

    def for_batch(self, batch) -> "Runtime":
        """This runtime for ``batch``: sequence parallelism only where
        every sequence it splits (the tokens, an encoder's frames) divides
        over "model" (the reference's constraint drops the split
        otherwise)."""
        if not self.sp:
            return self
        lens = [batch["tokens"].shape[1]]
        if "enc_frames" in batch:
            lens.append(batch["enc_frames"].shape[1])
        if all(n % self.tp == 0 for n in lens):
            return self
        return self.replace(seq_parallel=False)

    def shard(self, x, kind: str, *, partial: bool = False):
        """The reference's activation constraint of ``kind`` applied to a
        rank-local ``x`` that is whole over "model" (the rank's slice is
        taken: a view, so the gradient of the rest is the other ranks'),
        or, with ``partial``, a partial sum over it (reduce-scattered to
        the slice, or all-reduced)."""
        if self.tp == 1:
            return x
        spec = self._constraint(tuple(x.shape), kind)
        dim = None if spec is None else next(
            (d for d, ax in enumerate(spec) if ax == TP_AXIS), None)
        if partial:
            return (tp_lib.sum_shards(x, self.group) if dim is None
                    else tp_lib.reduce_scatter_seq(x, self.group, dim))
        return x if dim is None else tp_lib.own_slice(x, self.group, dim)

    def seq_span(self, S: int) -> tuple:
        """(first position, count) of the rank's part of a sequence of S."""
        if not self.sp:
            return 0, S
        return self.tp_rank * (S // self.tp), S // self.tp

    # -- a layer's work in and out of the residual stream --------------------

    def region_in(self, h, split: bool):
        """A layer's input from the residual stream ``h``.  ``split`` work
        (each rank its heads or columns, so its gradient of the input is a
        partial sum) enters through ``enter``; whole work takes ``h`` as it
        is.  Under sequence parallelism the sequence is gathered (its
        gradient reduce-scattered: whole work ends on the rank's slice, so
        its gradient is partial too)."""
        if self.tp == 1:
            return h
        if self.sp:
            return tp_lib.gather_seq(h, self.group, 1)
        return tp_lib.enter(h, self.group) if split else h

    def region_out(self, y, split: bool):
        """A layer's output back to the residual stream: ``split`` work's
        partial sums summed (reduce-scattered to the rank's slice under
        sequence parallelism); whole work's output as it is (its slice
        under sequence parallelism)."""
        if self.tp == 1:
            return y
        if split:
            return (tp_lib.reduce_scatter_seq(y, self.group, 1) if self.sp
                    else tp_lib.sum_shards(y, self.group))
        return tp_lib.own_slice(y, self.group, 1) if self.sp else y

    def ctx_in(self, ctx, split: bool):
        """A tensor whole on every rank (a cross-attention context, the
        sLSTM's conv output) into a layer's work: ``region_in`` without
        the gather."""
        if self.tp == 1 or self.sp or not split:
            return ctx
        return tp_lib.enter(ctx, self.group)

    def heads(self, n_heads: int) -> tuple:
        """(h0, h1): the rank's whole heads of ``n_heads`` over "model"
        (``sharding.head_range``: uneven where they do not divide; all of
        them on one rank)."""
        return head_range(n_heads, self.tp, self.tp_rank)

    def head_sizes(self, n_heads: int, unit: int = 1) -> list:
        """Each rank's count of heads of ``n_heads``, times ``unit`` (a
        head's channels), in rank order: what ``gather_channels`` takes
        for the ranks' heads."""
        return [(h1 - h0) * unit for h0, h1 in
                (head_range(n_heads, self.tp, r) for r in range(self.tp))]

    def gather_channels(self, x, *, partial: bool = True, sizes=None):
        """The rank's channels of ``x`` (its last dim; ``sizes``, each
        rank's count, where they are uneven) made whole over "model":
        all-gather forward; backward, the reduce-scatter of a gradient
        that is a partial sum over the group (``partial``: split work
        reads the whole, or the sequence is split after), else the rank's
        slice of a gradient that is the same on every rank."""
        if self.tp == 1:
            return x
        if partial:
            return tp_lib.gather_seq(x, self.group, x.ndim - 1, sizes)
        return tp_lib.gather_shards(x, self.group, x.ndim - 1, sizes)

    def whole_seq(self, x):
        """The whole sequence of a residual stream (an encoder's output,
        which every rank's cross-attention reads)."""
        return tp_lib.gather_seq(x, self.group, 1) if self.sp else x

    def moe_in(self, h):
        """The MoE layer's input: ``moe_ep`` takes token rows whole over
        "model", its gradient too, so under sequence parallelism the
        sequence is gathered (the rank keeps its slice of the gradient)."""
        return tp_lib.gather_shards(h, self.group, 1) if self.sp else h

    def moe_out(self, y):
        return tp_lib.scatter_seq(y, self.group, 1) if self.sp else y

    def use(self, block):
        """The parameters a layer computes with: the block itself, or what
        ``param_fn`` makes of it at the moment of use (the sharded train
        step gathers the layer's shards there)."""
        if self.param_fn is None:
            return block
        return self.param_fn(block)


NULL_RT = Runtime()


class KVShard(dict):
    """An attention cache (``k``/``v`` or ``ek``/``ev``, (B, L, KH, hd))
    holding positions ``start`` … ``start + L − 1`` of a KV length of
    ``total`` split over "model" (``sharding.cache_shardings``): decode
    attends over the slice and merges over the group."""

    def __init__(self, tensors, *, start: int, total: int):
        super().__init__(tensors)
        self.start, self.total = start, total


def kv_span(cache) -> tuple:
    """(first position, KV length) of an attention cache."""
    if isinstance(cache, KVShard):
        return cache.start, cache.total
    return 0, next(iter(cache.values())).shape[1]


# ---------------------------------------------------------------------- FFN

def init_mlp(seed, cfg, *, device):
    kg = KeyGen(seed)
    D, F = cfg.d_model, cfg.d_ff
    pdt = cfg.param_dtype_torch
    p = {}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        p["wi_gate"] = dense_init(kg(), D, F, pdt, device=device)
        p["wi_up"] = dense_init(kg(), D, F, pdt, device=device)
    else:
        p["wi"] = dense_init(kg(), D, F, pdt, device=device)
    p["wo"] = dense_init(kg(), F, D, pdt, scale=F ** -0.5, device=device)
    if cfg.mlp_bias:
        p["bi"] = torch.zeros((F,), dtype=pdt, device=device)
        p["bo"] = torch.zeros((D,), dtype=pdt, device=device)
    return p


def apply_mlp(p, x, cfg, rt=None):
    return ffn(p, x, d_ff=cfg.d_ff,
               gated=cfg.mlp_kind in ("swiglu", "geglu"),
               act=silu if cfg.mlp_kind == "swiglu" else gelu, rt=rt)


def ffn(p, x, *, d_ff: int, gated: bool, act, rt=None):
    """An MLP of ``d_ff`` columns: act(x·wi_gate) ⊙ (x·wi_up) when
    ``gated``, else act(x·wi + bi); then ·wo + bo.  Given this rank's
    columns (``wo`` of fewer than ``d_ff`` rows) it runs column- then
    row-parallel over "model"."""
    rt = rt or NULL_RT
    split = p["wo"].shape[0] < d_ff
    x = rt.region_in(x, split)
    if gated:
        h = act(x @ p["wi_gate"].to(x.dtype)) * (x @ p["wi_up"].to(x.dtype))
    else:
        h = x @ p["wi"].to(x.dtype)
        if "bi" in p:
            h = h + p["bi"].to(x.dtype)
        h = act(h)
    y = rt.region_out(h @ p["wo"].to(x.dtype), split)
    if "bo" in p:
        y = y + p["bo"].to(x.dtype)
    return y


def _init_ffn(seed, cfg, *, device):
    """FFN = dense MLP or MoE depending on cfg."""
    if cfg.moe.n_experts > 0:
        return {"moe": moe_lib.init_moe(seed, cfg, device=device)}
    return {"mlp": init_mlp(seed, cfg, device=device)}


def _apply_ffn(p, x, cfg, mode="train", rt=None):
    """(y, aux): aux is the MoE router loss, or 0.0 without MoE.  A
    runtime over a mesh with an expert axis runs expert parallelism, the
    shared expert tensor-parallel beside it."""
    if "moe" in p:
        if rt is not None and rt.mesh is not None and rt.ep_axis is not None:
            experts = {k: v for k, v in p["moe"].items() if k != "shared"}
            y, aux = moe_lib.moe_ep(experts, rt.moe_in(x), cfg, rt.mesh,
                                    data_axes=rt.data_axes,
                                    model_axis=rt.ep_axis)
            y = rt.moe_out(y)
            if "shared" in p["moe"]:
                y = y + ffn(p["moe"]["shared"], x, d_ff=cfg.d_ff, gated=True,
                            act=silu, rt=rt)
            return y, aux
        return moe_lib.moe_local(p["moe"], x, cfg,
                                 dropless=(mode == "decode"))
    return apply_mlp(p["mlp"], x, cfg, rt), 0.0


# ------------------------------------------------------------ block: attn --

def _rope_positions(mode, S, pos, device):
    """Positions for rope: a decode step's ``pos`` (an int, or a 1-D tensor
    of one position per sequence), else 0..S−1 offset by ``pos``."""
    if mode == "decode":
        if torch.is_tensor(pos) and pos.ndim == 1:
            return pos[:, None]
        return torch.full((1, 1), int(pos), device=device)
    return torch.arange(S, device=device)[None, :] + pos


def init_attn_block(seed, cfg, *, kind: str, device):
    kg = KeyGen(seed)
    D = cfg.d_model
    pdt = cfg.param_dtype_torch
    p = {"norm1": init_norm(kg(), D, pdt, cfg.norm_kind, device=device),
         "attn": attn_lib.init_attn(kg(), cfg, device=device),
         "norm2": init_norm(kg(), D, pdt, cfg.norm_kind, device=device),
         "ffn": _init_ffn(kg(), cfg, device=device)}
    if kind == "attn_cross":
        p["norm_x"] = init_norm(kg(), D, pdt, cfg.norm_kind, device=device)
        p["xattn"] = attn_lib.init_attn(kg(), cfg, cross=True, device=device)
    return p


def _fill_self_cache(cache, k, v, window: int) -> None:
    """Prefill: write the prompt's K/V (all KV heads) into the
    preallocated cache, or into its slice of the KV length."""
    S = k.shape[1]
    start, W = kv_span(cache)
    n = cache["k"].shape[1]
    if window > 0 and W < S:
        # the ring in phase: position t in slot t mod W, where decode
        # writes it (the last W positions rotated by S mod W)
        ring = slice(start, start + n)
        cache["k"].copy_(torch.roll(k[:, -W:], S % W, dims=1)[:, ring])
        cache["v"].copy_(torch.roll(v[:, -W:], S % W, dims=1)[:, ring])
        return
    if S > W:
        raise ValueError(f"a prompt of {S} tokens does not fit a KV cache "
                         f"of {W}")
    m = max(0, min(S - start, n))
    cache["k"][:, :m] = k[:, start:start + m]
    cache["v"][:, :m] = v[:, start:start + m]
    cache["k"][:, m:] = 0
    cache["v"][:, m:] = 0


def _fill_cross_cache(cache, k, v) -> None:
    start, _ = kv_span(cache)
    n = cache["ek"].shape[1]
    cache["ek"].copy_(k[:, start:start + n])
    cache["ev"].copy_(v[:, start:start + n])


def _whole_heads(q, n_heads: int, rt):
    """A decode step's query (B, 1, Hl, hd) of the rank's heads made
    whole over them (every rank attends with all of them over its slice
    of the KV length): the ranks' uneven heads gathered padded."""
    if rt.tp == 1:
        return q
    return tp_lib.all_gather(q, rt.group, 2, rt.head_sizes(n_heads))


def _decode_attend(q, cache_k, cache_v, *, kv_valid, softcap, rt, cache):
    """Decode attention of every query head (q made whole over heads)
    over the cache; a cache split over "model" (``KVShard``) attends over
    its slice and merges the partial softmax states over the group (the
    reference's distributed flash-decode, its psum combine).  Returns
    (B, 1, H, hd)."""
    if not isinstance(cache, KVShard):
        return attn_lib.dense_attention(q, cache_k, cache_v, causal=False,
                                        kv_valid=kv_valid, softcap=softcap)
    n = cache_k.shape[1]
    valid = None if kv_valid is None else \
        max(0, min(kv_valid - cache.start, n))
    return attn_lib.merged_decode(q, cache_k, cache_v, kv_valid=valid,
                                  softcap=softcap, group=rt.group)


def _self_attention(p, h, cfg, *, causal, window, mode, cache, pos, rt):
    """Shared self-attention core; writes the cache in place.  ``h`` is
    the residual stream's layout; the result is too."""
    rt = rt or NULL_RT
    H, hd = cfg.n_heads, cfg.head_dim
    heads = rt.heads(H)
    Hl, split = heads[1] - heads[0], rt.tp > 1
    x = rt.region_in(h, split)
    B, S, _ = x.shape
    if cfg.pos_kind == "rope":
        rpos = _rope_positions(mode, S, pos, x.device)

        def rotate(t):
            return rope(t, rpos, cfg.rope_theta)
    else:
        def rotate(t):
            return t
    decode = mode == "decode"
    q, k, v, k_all, v_all = attn_lib.qkv(
        p, x, cfg, rotate=rotate, whole_kv=decode or cache is not None,
        heads=heads, group=rt.group)
    if decode:
        ck, cv = cache["k"], cache["v"]
        start, W = kv_span(cache)
        pos = int(pos)
        slot = pos % W if window > 0 else pos
        if slot >= W:
            raise ValueError(f"decode position {pos} is past the KV cache's "
                             f"{W} slots")
        if start <= slot < start + ck.shape[1]:
            ck[:, slot - start:slot - start + 1] = k_all
            cv[:, slot - start:slot - start + 1] = v_all
        out = _decode_attend(_whole_heads(q, H, rt), ck, cv,
                             kv_valid=min(pos + 1, W),
                             softcap=cfg.logit_softcap, rt=rt, cache=cache)
        out = out[:, :, heads[0]:heads[1]]
    else:
        if cfg.attn_chunk and S > cfg.attn_chunk:
            out = attn_lib.blockwise_attention(
                q, k, v, causal=causal, window=window,
                q_chunk=cfg.attn_chunk, kv_chunk=cfg.attn_chunk,
                softcap=cfg.logit_softcap, causal_skip=cfg.causal_skip)
        else:
            out = attn_lib.dense_attention(q, k, v, causal=causal,
                                           window=window,
                                           softcap=cfg.logit_softcap)
        if cache is not None:
            _fill_self_cache(cache, k_all, v_all, window)
    out = out.reshape(B, S, Hl * hd) @ attn_lib.head_part(
        p["wo"], heads, hd, H, 0).to(x.dtype)
    out = rt.region_out(out, split)
    if "bo" in p:
        out = out + p["bo"].to(out.dtype)
    return out


def _cross_attention(p, h, cfg, *, ctx, cache, mode, rt):
    """Cross-attention; KV from ctx (train/prefill, which fills the cache)
    or from the cache (decode)."""
    rt = rt or NULL_RT
    H, hd = cfg.n_heads, cfg.head_dim
    heads = rt.heads(H)
    Hl, split = heads[1] - heads[0], rt.tp > 1
    x = rt.region_in(h, split)
    B, S, _ = x.shape
    if mode == "decode" and cache is not None and "ek" in cache:
        bq = p.get("bq")
        q = attn_lib.proj(x, attn_lib.head_part(p["wq"], heads, hd, H),
                          None if bq is None
                          else attn_lib.head_part(bq, heads, hd, H))
        out = _decode_attend(_whole_heads(q.reshape(B, S, Hl, hd), H, rt),
                             cache["ek"], cache["ev"], kv_valid=None,
                             softcap=cfg.logit_softcap, rt=rt, cache=cache)
        out = out[:, :, heads[0]:heads[1]]
    else:
        q, k, v, k_all, v_all = attn_lib.qkv(
            p, x, cfg, rt.ctx_in(ctx, split), whole_kv=cache is not None,
            heads=heads, group=rt.group)
        if cache is not None:
            _fill_cross_cache(cache, k_all, v_all)
        out = attn_lib.dense_attention(q, k, v, causal=False,
                                       softcap=cfg.logit_softcap)
    out = out.reshape(B, S, Hl * hd) @ attn_lib.head_part(
        p["wo"], heads, hd, H, 0).to(x.dtype)
    return rt.region_out(out, split)


def apply_attn_block(p, x, cfg, *, kind, mode, cache, pos, ctx,
                     rt=None):
    causal = cfg.family != "audio_encoder" and kind != "enc_attn"
    window = cfg.window if kind == "local_attn" else 0

    h = apply_norm(p["norm1"], x, cfg.norm_kind)
    sc = cache.get("self") if cache is not None else None
    x = x + _self_attention(p["attn"], h, cfg, causal=causal, window=window,
                            mode=mode, cache=sc, pos=pos, rt=rt)

    if kind == "attn_cross":
        h = apply_norm(p["norm_x"], x, cfg.norm_kind)
        xc = cache.get("cross") if cache is not None else None
        x = x + _cross_attention(p["xattn"], h, cfg, ctx=ctx, cache=xc,
                                 mode=mode, rt=rt)

    h = apply_norm(p["norm2"], x, cfg.norm_kind)
    y, aux = _apply_ffn(p["ffn"], h, cfg, mode, rt)
    return x + y, aux


# --------------------------------------------------- block: gated xattn ----

def init_xattn_block(seed, cfg, *, device):
    kg = KeyGen(seed)
    D = cfg.d_model
    pdt = cfg.param_dtype_torch
    f32 = torch.float32
    return {
        "norm1": init_norm(kg(), D, pdt, cfg.norm_kind, device=device),
        "xattn": attn_lib.init_attn(kg(), cfg, cross=True, device=device),
        "gate_attn": torch.zeros((), dtype=f32, device=device),
        "norm2": init_norm(kg(), D, pdt, cfg.norm_kind, device=device),
        "ffn": _init_ffn(kg(), cfg, device=device),
        "gate_ffn": torch.zeros((), dtype=f32, device=device),
    }


def apply_xattn_block(p, x, cfg, *, mode, cache, ctx, rt=None):
    """Llama-3.2-vision style gated cross-attention layer."""
    h = apply_norm(p["norm1"], x, cfg.norm_kind)
    xc = cache.get("cross") if cache is not None else None
    out = _cross_attention(p["xattn"], h, cfg, ctx=ctx, cache=xc, mode=mode,
                           rt=rt)
    x = x + torch.tanh(p["gate_attn"]).to(x.dtype) * out
    h = apply_norm(p["norm2"], x, cfg.norm_kind)
    y, aux = _apply_ffn(p["ffn"], h, cfg, mode, rt)
    return x + torch.tanh(p["gate_ffn"]).to(x.dtype) * y, aux


# ------------------------------------------------------- block: rglru ------

def init_rglru_block(seed, cfg, *, device):
    kg = KeyGen(seed)
    D = cfg.d_model
    lru = cfg.d_model            # Griffin: lru_width == d_model
    pdt = cfg.param_dtype_torch
    return {
        "norm1": init_norm(kg(), D, pdt, cfg.norm_kind, device=device),
        "wy": dense_init(kg(), D, lru, pdt, device=device),
        "wgate": dense_init(kg(), D, lru, pdt, device=device),
        "conv": rec_lib.init_conv1d(kg(), lru, cfg.conv_width, pdt,
                                    device=device),
        "lru": rec_lib.init_rglru(kg(), lru, pdt, device=device),
        "wout": dense_init(kg(), lru, D, pdt, scale=lru ** -0.5,
                           device=device),
        "norm2": init_norm(kg(), D, pdt, cfg.norm_kind, device=device),
        "ffn": _init_ffn(kg(), cfg, device=device),
    }


def rglru_mixer(p, x, cfg, *, mode, cache, rt=None):
    """The RG-LRU block's recurrent mixer on the residual stream ``x``:
    what it adds to it (the decode cache written in place).  Given the
    rank's channels (``wy`` of fewer than d_model columns) it runs split
    over "model": the projections, conv and scan on its channels, the
    gates' products on all of them (gathered), the output row-parallel."""
    rt = rt or NULL_RT
    split = p["wy"].shape[-1] < cfg.d_model
    h = rt.region_in(apply_norm(p["norm1"], x, cfg.norm_kind), split)
    y = h @ p["wy"].to(h.dtype)
    gate = gelu(h @ p["wgate"].to(h.dtype))
    if mode == "decode":
        yc, new_conv = rec_lib.conv1d_causal(p["conv"], y, cache["conv"])
        y_t, new_h = rec_lib.rglru_step(
            p["lru"], yc[:, 0], cache["h"], c=cfg.rglru_c,
            xg_t=rt.gather_channels(yc[:, 0]) if split else None)
        y = y_t[:, None, :]
    else:
        yc, new_conv = rec_lib.conv1d_causal(p["conv"], y, None)
        y, new_h = rec_lib.rglru_scan(
            p["lru"], yc, c=cfg.rglru_c,
            xg=rt.gather_channels(yc) if split else None)
    if cache is not None:
        cache["h"].copy_(new_h)
        cache["conv"].copy_(new_conv)
    return rt.region_out((y * gate) @ p["wout"].to(x.dtype), split)


def apply_rglru_block(p, x, cfg, *, mode, cache, rt=None):
    """``rglru_mixer``, then the FFN tensor-parallel."""
    x = x + rglru_mixer(p, x, cfg, mode=mode, cache=cache, rt=rt)
    h2 = apply_norm(p["norm2"], x, cfg.norm_kind)
    z, aux = _apply_ffn(p["ffn"], h2, cfg, mode, rt)
    return x + z, aux


# ------------------------------------------------- blocks: mlstm / slstm ---

def init_mlstm_block(seed, cfg, *, device):
    kg = KeyGen(seed)
    D = cfg.d_model
    d_in = 2 * D                                   # xLSTM proj_factor = 2
    pdt = cfg.param_dtype_torch
    return {
        "norm": init_norm(kg(), D, pdt, cfg.norm_kind, device=device),
        "wup": dense_init(kg(), D, 2 * d_in, pdt, device=device),  # [x_m, z]
        "conv": rec_lib.init_conv1d(kg(), d_in, cfg.conv_width, pdt,
                                    device=device),
        "cell": rec_lib.init_mlstm_cell(kg(), d_in, cfg.n_heads, pdt,
                                        device=device),
        "wdown": dense_init(kg(), d_in, D, pdt, scale=d_in ** -0.5,
                            device=device),
    }


def xlstm_part(p, cfg, kind: str, rt) -> tuple:
    """(the leaves of an mLSTM or sLSTM block that the rank computes its
    cell with, its count of heads): its whole heads' part of each
    (``rt.heads``; all of them on one rank), taken from a whole leaf or
    arriving as the rank's shard where the heads divide "model".  mLSTM:
    ``wup``'s x_m and z columns, the conv's channels, the cell's q, k, v
    columns and gates, ``wdown``'s rows; sLSTM: the cell's gate columns,
    biases and recurrent blocks (its conv whole)."""
    H = cfg.n_heads
    heads = rt.heads(H)
    cell = p["cell"]
    if kind == "mlstm":
        dh = 2 * cfg.d_model // H

        def part(t, unit=dh, dim=-1):
            return attn_lib.head_part(t, heads, unit, H, dim)
        return {"wup": torch.cat([part(w) for w in torch.chunk(
                    p["wup"], 2, dim=-1)], dim=-1),
                "conv": {k: part(p["conv"][k]) for k in ("w", "b")},
                "cell": {**{k: part(cell[k]) for k in ("wq", "wk", "wv")},
                         **{k: part(cell[k], 1)
                            for k in ("wi", "wf", "bi", "bf")}},
                "wdown": part(p["wdown"], dim=0)}, heads[1] - heads[0]
    dh = cfg.d_model // H
    return {"conv": p["conv"], "cell": {
        k: attn_lib.head_part(cell[k], heads, 1 if k[0] == "r" else dh, H,
                              0 if k[0] == "r" else -1)
        for k in ("wz", "wo", "wi", "wf", "bz", "bi", "bf", "bo",
                  "rz", "ri", "rf", "ro")}}, heads[1] - heads[0]


def mlstm_mixer(p, x, cfg, *, mode, cache, rt=None):
    """The mLSTM block (its projections and cell: the whole block, which
    has no FFN) on the residual stream ``x``: what it adds to it (the
    decode cache written in place).  On a runtime over "model" it runs
    split on the rank's whole heads (``xlstm_part``; uneven, or none,
    where they do not divide): ``wup`` gives its heads' x_m and z
    columns; the conv runs on their channels, q, k, v and the gates on
    the whole conv output (gathered) and the cell on its heads; ``wdown``
    row-parallel."""
    rt = rt or NULL_RT
    split = rt.tp > 1
    h = rt.region_in(apply_norm(p["norm"], x, cfg.norm_kind), split)
    part, H = xlstm_part(p, cfg, "mlstm", rt)
    up = h @ part["wup"].to(h.dtype)
    xm, z = torch.chunk(up, 2, dim=-1)
    decode = mode == "decode"
    c, new_conv = rec_lib.conv1d_causal(part["conv"], xm,
                                        cache["conv"] if decode else None)
    c = silu(c)
    if split:
        c = rt.gather_channels(c, sizes=rt.head_sizes(
            cfg.n_heads, 2 * cfg.d_model // cfg.n_heads))
    if decode:
        y, new_state = rec_lib.mlstm_step(
            part["cell"], c[:, 0], H, (cache["C"], cache["n"], cache["m"]))
        y = y[:, None, :]
    else:
        y, new_state = rec_lib.mlstm_chunked(part["cell"], c, H,
                                             chunk=cfg.mlstm_chunk)
    if cache is not None:
        for name, t in zip(("C", "n", "m"), new_state or ()):
            cache[name].copy_(t)
        cache["conv"].copy_(new_conv)
    return rt.region_out((y * silu(z)) @ part["wdown"].to(x.dtype), split)


def apply_mlstm_block(p, x, cfg, *, mode, cache, rt=None):
    return x + mlstm_mixer(p, x, cfg, mode=mode, cache=cache, rt=rt), 0.0


def init_slstm_block(seed, cfg, *, device):
    kg = KeyGen(seed)
    D = cfg.d_model
    pdt = cfg.param_dtype_torch
    f = (4 * D) // 3
    return {
        "norm": init_norm(kg(), D, pdt, cfg.norm_kind, device=device),
        "conv": rec_lib.init_conv1d(kg(), D, cfg.conv_width, pdt,
                                    device=device),
        "cell": rec_lib.init_slstm_cell(kg(), D, cfg.n_heads, pdt,
                                        device=device),
        "norm2": init_norm(kg(), D, pdt, cfg.norm_kind, device=device),
        "ffn_gate": dense_init(kg(), D, f, pdt, device=device),
        "ffn_up": dense_init(kg(), D, f, pdt, device=device),
        "ffn_down": dense_init(kg(), f, D, pdt, scale=f ** -0.5,
                               device=device),
    }


def slstm_mixer(p, x, cfg, *, mode, cache, rt=None):
    """The sLSTM block's conv and cell on the residual stream ``x``: what
    they add to it (the decode cache written in place).  On a runtime
    over "model" the cell runs on the rank's whole heads (``xlstm_part``;
    uneven, or none, where they do not divide), on the whole conv output
    (the conv runs whole), and its heads' outputs are gathered (the cell
    has no projection back)."""
    rt = rt or NULL_RT
    split = rt.tp > 1
    h = rt.region_in(apply_norm(p["norm"], x, cfg.norm_kind), False)
    decode = mode == "decode"
    c, new_conv = rec_lib.conv1d_causal(
        p["conv"], h, cache["conv"] if decode else None)
    c = rt.ctx_in(silu(c), split)
    part, H = xlstm_part(p, cfg, "slstm", rt)
    if decode:
        state = (cache["c"], cache["n"], cache["h"], cache["m"])
        y, new_state = rec_lib.slstm_step(part["cell"], c[:, 0], H, state)
        y = y[:, None, :]
    else:
        y, new_state = rec_lib.slstm_scan(part["cell"], c, H, None)
    if cache is not None:
        for name, t in zip(("c", "n", "h", "m"), new_state or ()):
            cache[name].copy_(t)
        cache["conv"].copy_(new_conv)
    if split:
        # the gradient of the whole output is the same on every rank, or,
        # where the sequence is split after, a partial sum
        y = rt.gather_channels(y, partial=rt.sp, sizes=rt.head_sizes(
            cfg.n_heads, cfg.d_model // cfg.n_heads))
    return rt.region_out(y, False)


def apply_slstm_block(p, x, cfg, *, mode, cache, rt=None):
    """``slstm_mixer``, then the GeGLU FFN tensor-parallel."""
    x = x + slstm_mixer(p, x, cfg, mode=mode, cache=cache, rt=rt)
    h2 = apply_norm(p["norm2"], x, cfg.norm_kind)
    return x + ffn({"wi_gate": p["ffn_gate"], "wi_up": p["ffn_up"],
                    "wo": p["ffn_down"]}, h2, d_ff=(4 * cfg.d_model) // 3,
                   gated=True, act=gelu, rt=rt), 0.0


# ------------------------------------------------------------ the modules --

class Block(ParamTree):
    """One layer: the reference's parameter dict of its kind as a
    ``ParamTree``; ``forward(x, *, mode, cache, pos, ctx, rt)`` returns
    (x, aux) and writes ``cache`` (this layer's dict, or None) in place."""

    def __init__(self, cfg, kind: str, tree):
        super().__init__(tree)
        self.cfg, self.kind = cfg, kind

    def params(self, rt):
        """This layer's parameters as ``rt`` has them used."""
        return self if rt is None else rt.use(self)


class AttnBlock(Block):
    """``attn``, ``local_attn``, ``attn_cross`` and ``enc_attn``."""

    def forward(self, x, *, mode="train", cache=None, pos=0, ctx=None,
                rt=None):
        return apply_attn_block(self.params(rt), x, self.cfg, kind=self.kind,
                                mode=mode, cache=cache, pos=pos, ctx=ctx,
                                rt=rt)


class XAttnBlock(Block):
    def forward(self, x, *, mode="train", cache=None, pos=0, ctx=None,
                rt=None):
        del pos
        return apply_xattn_block(self.params(rt), x, self.cfg, mode=mode,
                                 cache=cache, ctx=ctx, rt=rt)


class RGLRUBlock(Block):
    def forward(self, x, *, mode="train", cache=None, pos=0, ctx=None,
                rt=None):
        del pos, ctx
        return apply_rglru_block(self.params(rt), x, self.cfg, mode=mode,
                                 cache=cache, rt=rt)


class MLSTMBlock(Block):
    def forward(self, x, *, mode="train", cache=None, pos=0, ctx=None,
                rt=None):
        del pos, ctx
        return apply_mlstm_block(self.params(rt), x, self.cfg, mode=mode,
                                 cache=cache, rt=rt)


class SLSTMBlock(Block):
    def forward(self, x, *, mode="train", cache=None, pos=0, ctx=None,
                rt=None):
        del pos, ctx
        return apply_slstm_block(self.params(rt), x, self.cfg, mode=mode,
                                 cache=cache, rt=rt)


BLOCKS = {"attn": AttnBlock, "local_attn": AttnBlock,
          "attn_cross": AttnBlock, "enc_attn": AttnBlock,
          "xattn": XAttnBlock, "rglru": RGLRUBlock, "mlstm": MLSTMBlock,
          "slstm": SLSTMBlock}


def init_block(seed, cfg, kind: str, *, device):
    if kind in ("attn", "local_attn", "attn_cross", "enc_attn"):
        return init_attn_block(seed, cfg, kind=kind, device=device)
    if kind == "xattn":
        return init_xattn_block(seed, cfg, device=device)
    if kind == "rglru":
        return init_rglru_block(seed, cfg, device=device)
    if kind == "mlstm":
        return init_mlstm_block(seed, cfg, device=device)
    if kind == "slstm":
        return init_slstm_block(seed, cfg, device=device)
    raise ValueError(f"unknown block kind {kind!r}")


# ----------------------------------------------------------- cache init ----

def init_block_cache(cfg, kind: str, batch: int, kv_len: int,
                     enc_len: int = 0, *, device, rt=None):
    """One layer's decode cache.  On a runtime over "model" an attention
    cache whose KV length divides the group holds the rank's slice of it
    (a ``KVShard``), and a recurrent state the rank's channels or heads
    where its mixer runs split, as ``sharding.cache_shardings`` and
    ``sharding.recurrent_cache_slices`` split them."""
    KH, hd = cfg.n_kv, cfg.head_dim
    cdt = cfg.dtype_torch
    f32 = torch.float32
    tp = rt.tp if rt is not None else 1

    def z(*shape, dtype=cdt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(names, length):
        if tp > 1 and length % tp == 0:
            n = length // tp
            return KVShard({k: z(batch, n, KH, hd) for k in names},
                           start=rt.tp_rank * n, total=length)
        return {k: z(batch, length, KH, hd) for k in names}

    if kind in ("attn", "local_attn", "attn_cross", "enc_attn"):
        W = min(cfg.window, kv_len) if kind == "local_attn" and cfg.window \
            else kv_len
        c = {"self": kv(("k", "v"), W)}
        if kind == "attn_cross":
            c["cross"] = kv(("ek", "ev"), enc_len)
        return c
    if kind == "xattn":
        return {"cross": kv(("ek", "ev"), enc_len)}
    # a recurrent state: the rank's 1/tp of the RG-LRU's channels where
    # they divide, its whole heads of an xLSTM cell (``Runtime.heads``)
    h0, h1 = rt.heads(cfg.n_heads) if rt is not None else (0, cfg.n_heads)
    H = h1 - h0
    if kind == "rglru":
        lru = cfg.d_model
        lru //= tp if tp > 1 and lru % tp == 0 else 1
        return {"h": z(batch, lru, dtype=f32),
                "conv": z(batch, cfg.conv_width - 1, lru)}
    if kind == "mlstm":
        dh = 2 * cfg.d_model // cfg.n_heads
        return {"C": z(batch, H, dh, dh, dtype=f32),
                "n": z(batch, H, dh, dtype=f32),
                "m": z(batch, H, dtype=f32) - 1e30,
                "conv": z(batch, cfg.conv_width - 1, H * dh)}
    if kind == "slstm":
        dh = cfg.d_model // cfg.n_heads
        return {"c": z(batch, H, dh, dtype=f32),
                "n": z(batch, H, dh, dtype=f32) + 1e-6,
                "h": z(batch, H, dh, dtype=f32),
                "m": z(batch, H, dh, dtype=f32) - 1e30,
                "conv": z(batch, cfg.conv_width - 1, cfg.d_model)}
    raise ValueError(kind)


# ------------------------------------------------------------- stacks ------

def layer_kinds(pattern, n_layers):
    """(period, n_groups, tail kinds) of a cycled pattern."""
    period = len(pattern)
    n_groups = n_layers // period
    tail = tuple(pattern[i] for i in range(n_layers - n_groups * period))
    return period, n_groups, tail


def init_stack(seed, cfg, pattern, n_layers, *, device):
    """Per-layer params: {"groups": {"p{i}": [one dict per group]} or None,
    "tail": [...]} (the reference stacks each "p{i}" over the groups)."""
    period, n_groups, tail = layer_kinds(pattern, n_layers)
    kg = KeyGen(seed)
    groups = None
    if n_groups > 0:
        groups = {f"p{pos}": [init_block(kg(), cfg, pattern[pos],
                                         device=device)
                              for _ in range(n_groups)]
                  for pos in range(period)}
    tail_params = [init_block(kg(), cfg, kind, device=device)
                   for kind in tail]
    return {"groups": groups, "tail": tail_params}


def init_stack_cache(cfg, pattern, n_layers, batch, kv_len, enc_len=0, *,
                     device, rt=None):
    """One cache dict per layer, in layer order."""
    return [init_block_cache(cfg, pattern[layer % len(pattern)], batch,
                             kv_len, enc_len, device=device, rt=rt)
            for layer in range(n_layers)]


class Stack(nn.Module):
    """The layers of one stack; ``state_dict`` keys ``groups.p{i}.{g}.…``
    and ``tail.{t}.…`` name the reference's ``groups/p{i}/…`` leaf (at
    index g of its stacked axis) and ``tail[t]/…``."""

    def __init__(self, cfg, pattern, n_layers: int, tree):
        super().__init__()
        self.cfg = cfg
        period, n_groups, tail = layer_kinds(pattern, n_layers)
        self.groups = None
        if n_groups > 0:
            self.groups = nn.ModuleDict({
                f"p{i}": nn.ModuleList(BLOCKS[pattern[i]](cfg, pattern[i], t)
                                       for t in tree["groups"][f"p{i}"])
                for i in range(period)})
        self.tail = nn.ModuleList(BLOCKS[kind](cfg, kind, t)
                                  for kind, t in zip(tail, tree["tail"]))
        self._period, self._n_groups = period, n_groups

    def layers(self) -> list:
        """The blocks in layer order."""
        out = [self.groups[f"p{i}"][g] for g in range(self._n_groups)
               for i in range(self._period)]
        return out + list(self.tail)

    def tree(self):
        groups = None
        if self.groups is not None:
            groups = {k: [b.tree() for b in ml]
                      for k, ml in self.groups.items()}
        return {"groups": groups, "tail": [b.tree() for b in self.tail]}

    def forward(self, x, *, mode="train", caches=None, pos=0, ctx=None,
                rt=None):
        """Returns (x, aux_sum); ``caches`` (one dict per layer) are
        written in place.  A training forward with gradients runs each
        layer group under remat when ``cfg.remat`` is set."""
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        layers = self.layers()
        remat = (self.cfg.remat and mode == "train" and caches is None
                 and torch.is_grad_enabled())
        n_grouped = self._period * self._n_groups
        start = 0
        while start < len(layers):
            span = self._period if start < n_grouped else 1
            blocks = layers[start:start + span]
            if remat and start < n_grouped:
                x, aux_total = _checkpoint(blocks, x, aux_total, ctx, rt,
                                           policy=self.cfg.remat_policy)
            else:
                x, aux_total = _run_blocks(
                    blocks, x, aux_total, ctx, rt, mode=mode,
                    caches=None if caches is None
                    else caches[start:start + span], pos=pos)
            start += span
        return x, aux_total


def _run_blocks(blocks, x, aux_total, ctx, rt, *, mode="train", caches=None,
                pos=0):
    """Layers in order: (x, ``aux_total`` plus their aux, fp32)."""
    for i, blk in enumerate(blocks):
        c = caches[i] if caches is not None else None
        x, aux = blk(x, mode=mode, cache=c, pos=pos, ctx=ctx, rt=rt)
        if torch.is_tensor(aux):
            aux_total = aux_total + aux
    return x, aux_total


#: aten products whose outputs ``remat_policy="dots"`` keeps
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _checkpoint(blocks, x, aux_total, ctx, rt, *, policy: str):
    """``_run_blocks`` under non-reentrant activation checkpointing;
    "dots" keeps the products' outputs."""
    import functools
    from torch.utils import checkpoint as ckpt
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    elif policy != "full":
        raise ValueError(f"unknown remat_policy {policy!r}")
    return ckpt.checkpoint(_run_blocks, blocks, x, aux_total, ctx, rt,
                           use_reentrant=False, **kw)
