"""Top-level model: embeddings, stacks, loss, and the three entry points
(the training loss, prefill, decode) shared by all 10 architectures.
Counterpart of ``repro/models/lm.py``.

``LM(cfg, device=None, seed=0)`` builds the model on ``cuda`` unless the
caller asks for the CPU, from the port's own seeded init; parameters of the
JAX package come in through ``util.convert.lm_params_from_numpy``.
``prefill`` and ``decode_step`` run under ``torch.inference_mode()``.

Modality frontends are stubs per the assignment: ``[audio]`` models take
precomputed frame embeddings (B, S_enc, D); ``[vlm]`` models take
precomputed patch embeddings (B, N_img, D).  ``input_specs`` gives every
(arch × shape) cell's inputs as tensors on the ``meta`` device, the
counterpart of the reference's ``ShapeDtypeStruct`` / ``eval_shape``.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed import tensor_parallel as tp_lib
from repro_torch.models import transformer as tf
from repro_torch.models.common import (KeyGen, ParamTree, Params, apply_norm,
                                       dense_init, embed_init, init_norm,
                                       sinusoidal_freqs, sinusoidal_positions)
from repro_torch.util.device import resolve_device


# ------------------------------------------------------------------- params

def init_params(cfg: ModelConfig, seed: int, *, device) -> Params:
    """The port's seeded init, in the port's per-layer layout (each stack's
    ``groups["p{i}"]`` a list over groups)."""
    kg = KeyGen(seed)
    pdt = cfg.param_dtype_torch
    p: Params = {"embed": {"tok": embed_init(kg(), cfg.vocab, cfg.d_model,
                                             pdt, device=device)}}
    if cfg.pos_kind == "learned":
        p["embed"]["pos"] = embed_init(kg(), cfg.max_learned_pos, cfg.d_model,
                                       pdt, device=device)
    if cfg.is_encdec:
        p["enc"] = tf.init_stack(kg(), cfg, cfg.encoder_pattern,
                                 cfg.encoder_layers, device=device)
        p["enc_norm"] = init_norm(kg(), cfg.d_model, pdt, cfg.norm_kind,
                                  device=device)
    p["dec"] = tf.init_stack(kg(), cfg, cfg.layer_pattern, cfg.n_layers,
                             device=device)
    p["final_norm"] = init_norm(kg(), cfg.d_model, pdt, cfg.norm_kind,
                                device=device)
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(kg(), cfg.d_model, cfg.vocab, pdt,
                                  device=device)
    return p


def init_caches(cfg, batch_size: int, kv_len: int, enc_len: int = 0, *,
                device, rt=None):
    return tf.init_stack_cache(cfg, cfg.layer_pattern, cfg.n_layers,
                               batch_size, kv_len, enc_len, device=device,
                               rt=rt)


class LM(nn.Module):
    """The language model of ``cfg``.  ``state_dict`` keys are the
    reference's parameter key paths (``embed.tok``, ``dec.groups.p0.3.
    attn.wq`` for group 3 of ``dec/groups/p0/attn/wq``, ``dec.tail.0.…``,
    ``final_norm.scale``, ``unembed``).  ``params`` (the port's per-layer
    tree of tensors, see ``init_params``) replaces the seeded init; its
    tensors become the parameters' storage (``train.steps`` passes views
    of its stacked leaves).  A training forward honours ``cfg.remat``
    (``transformer.Stack``)."""

    def __init__(self, cfg: ModelConfig, *, device=None, seed: int = 0,
                 params: Params | None = None):
        super().__init__()
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, seed, device=resolve_device(device))
        self.embed = ParamTree(params["embed"])
        if cfg.is_encdec:
            self.enc = tf.Stack(cfg, cfg.encoder_pattern, cfg.encoder_layers,
                                params["enc"])
            self.enc_norm = ParamTree(params["enc_norm"])
        self.dec = tf.Stack(cfg, cfg.layer_pattern, cfg.n_layers,
                            params["dec"])
        self.final_norm = ParamTree(params["final_norm"])
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(params["unembed"])

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def tree(self) -> Params:
        """The parameters in the port's per-layer layout."""
        out = {name: m.tree() for name, m in self.named_children()}
        if not self.cfg.tie_embeddings:
            out["unembed"] = self.unembed.data
        return out

    # ---------------------------------------------------------- embeddings

    def _lookup(self, tokens, rt):
        """(token embeddings, whether they are a partial sum over
        "model"): a vocabulary-parallel table (this rank's rows) gives each
        token its row where the rank holds it and zeros elsewhere, exact
        once summed over the group."""
        tok = self.embed.tok
        dt = self.cfg.dtype_torch
        Vl = tok.shape[0]
        if Vl == self.cfg.vocab:
            return tok[tokens].to(dt), False
        ids = tokens.long() - rt.tp_rank * Vl
        inside = (ids >= 0) & (ids < Vl)
        rows = tok[ids.clamp(0, Vl - 1)].to(dt)
        return torch.where(inside[..., None], rows, torch.zeros_like(rows)), \
            True

    def embed_tokens(self, tokens, rt=tf.NULL_RT):
        """Token (+ position) embeddings in ``act_btd``'s layout: the
        reference's constraint applied (``Runtime.shard``)."""
        cfg = self.cfg
        x, partial = self._lookup(tokens, rt)
        x = rt.shard(x, "act_btd", partial=partial)
        p0, n = rt.seq_span(tokens.shape[1])
        if cfg.pos_kind == "learned":
            x = x + self.embed.pos[p0:p0 + n][None].to(x.dtype)
        elif cfg.pos_kind == "sinusoidal":
            x = x + sinusoidal_positions(p0 + n, cfg.d_model, x.dtype,
                                         device=x.device)[p0:][None]
        return x

    def _decode_pos_embed(self, x, pos):
        """Positional contribution for a single decode position."""
        cfg = self.cfg
        if cfg.pos_kind == "learned":
            return x + self.embed.pos[int(pos)][None, None].to(x.dtype)
        if cfg.pos_kind == "sinusoidal":
            ang = float(pos) * sinusoidal_freqs(cfg.d_model, x.device)
            pe = torch.cat([torch.sin(ang), torch.cos(ang)])[None, None]
            return x + pe.to(x.dtype)
        return x

    def logits(self, x, rt=tf.NULL_RT):
        """Unembed: fp32 logits (tied embeddings read ``embed.tok``), in
        ``act_btv``'s layout: this rank's vocabulary columns from the whole
        sequence where the table is split over "model", else the whole
        vocabulary of the residual stream's rows (under sequence
        parallelism, the rank's slice of the sequence)."""
        w = self.embed.tok.T if self.cfg.tie_embeddings else self.unembed
        if w.shape[1] < self.cfg.vocab:
            x = rt.region_in(x, True)
        return (x @ w.to(x.dtype)).float()

    def _encode(self, enc_inputs, rt=tf.NULL_RT):
        """Encoder for enc-dec (audio) models: frames (B, S_enc, D); the
        states come out whole over the sequence."""
        cfg = self.cfg
        x = enc_inputs.to(cfg.dtype_torch)
        if cfg.pos_kind in ("sinusoidal", "learned"):
            x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.dtype,
                                         device=x.device)[None]
        x, _ = self.enc(rt.shard(x, "act_btd"), mode="train", rt=rt)
        return rt.whole_seq(apply_norm(self.enc_norm, x, cfg.norm_kind))

    def context(self, batch, rt=tf.NULL_RT):
        """Cross-attention context from the modality stub, if any."""
        if self.cfg.is_encdec:
            return self._encode(batch["enc_frames"], rt)
        if self.cfg.frontend == "image_patches":
            return batch["img_embeds"].to(self.cfg.dtype_torch)
        return None

    # -------------------------------------------------------- entry points

    def forward(self, batch, *, rt=tf.NULL_RT, caches=None):
        """Full-sequence forward.  batch: {tokens, [enc_frames|img_embeds]}.
        Returns (logits fp32 (B,S,V), caches, aux); ``caches`` (from
        ``init_caches``) are filled in place: the prefill mode.  On a
        runtime over "model" the logits are ``logits``' layout: (B, S,
        V/tp) where the vocabulary splits."""
        rt = rt.for_batch(batch)
        return self._forward(batch, self.context(batch, rt), caches, rt)

    def _forward(self, batch, ctx, caches, rt):
        x = self.embed_tokens(batch["tokens"], rt)
        x, aux = self.dec(x, mode="prefill" if caches is not None
                          else "train", caches=caches, ctx=ctx, rt=rt)
        x = apply_norm(self.final_norm, x, self.cfg.norm_kind)
        return self.logits(x, rt), caches, aux

    def loss_fn(self, batch, *, rt=tf.NULL_RT):
        """Next-token cross entropy (+ MoE aux).  batch needs tokens,
        labels (< 0: ignored).  On a runtime over "model" it is the
        vocabulary-parallel cross entropy: the log-partition by a max and a
        sum all-reduce, the gold logit from the rank holding it; where the
        vocabulary does not split under sequence parallelism, each rank's
        positions' sum, summed over the group."""
        rt = rt.for_batch(batch)
        logits, _, aux = self.forward(batch, rt=rt)
        labels = batch["labels"]
        if logits.shape[-1] < self.cfg.vocab:
            logz, gold = vocab_parallel_terms(logits, labels, rt)
        else:
            if rt.sp:
                p0, n = rt.seq_span(labels.shape[1])
                labels = labels[:, p0:p0 + n]
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                labels.clamp_min(0).long()[..., None])[..., 0]
        mask = (labels >= 0).float()
        nll = (logz - gold) * mask
        if logits.shape[-1] == self.cfg.vocab and rt.sp:
            total = tp_lib.sum_shards(nll.sum(), rt.group)
            count = tp_lib.all_sum(mask.sum(), rt.group)
            loss = total / torch.clamp_min(count, 1.0)
        else:
            loss = nll.sum() / torch.clamp_min(mask.sum(), 1.0)
        return loss + aux, {"nll": loss, "aux": aux}

    def init_caches(self, batch_size: int, kv_len: int, enc_len: int = 0, *,
                    rt=None):
        return init_caches(self.cfg, batch_size, kv_len, enc_len,
                           device=self.device, rt=rt)

    @torch.inference_mode()
    def prefill(self, batch, kv_len: int, *, rt=tf.NULL_RT):
        """Run the prompt, building decode caches (on a runtime over
        "model", the rank's slice of each KV length).  Returns (logits,
        caches)."""
        rt = rt.for_batch(batch)
        B = batch["tokens"].shape[0]
        ctx = self.context(batch, rt)
        enc_len = ctx.shape[1] if ctx is not None else 0
        caches = self.init_caches(B, kv_len, enc_len, rt=rt)
        logits, caches, _ = self._forward(batch, ctx, caches, rt)
        return logits, caches

    @torch.inference_mode()
    def decode_step(self, caches, tokens, pos, *, ctx=None, rt=tf.NULL_RT):
        """One token for every sequence.  tokens (B, 1) integer, ``pos`` the
        position they take (an int).  Returns (logits (B, 1, V) fp32,
        caches), the caches written in place."""
        rt = rt.for_batch({"tokens": tokens})
        x, partial = self._lookup(tokens, rt)
        x = self._decode_pos_embed(rt.shard(x, "act_btd", partial=partial),
                                   pos)
        x, _ = self.dec(x, mode="decode", caches=caches, pos=pos, ctx=ctx,
                        rt=rt)
        x = apply_norm(self.final_norm, x, self.cfg.norm_kind)
        return self.logits(x, rt), caches

    def input_specs(self, shape: ShapeConfig) -> dict:
        return input_specs(self.cfg, shape)


def vocab_parallel_terms(logits, labels, rt):
    """(log-partition, gold logit) per position from this rank's
    vocabulary columns (B, S, V/tp) of the whole logits: the row max by a
    max all-reduce (no gradient; the log-partition's gradient does not
    depend on it), the sum of exponentials and the gold logit (held by one
    rank, zero on the others) by sum all-reduces whose gradient is each
    rank's own."""
    Vl = logits.shape[-1]
    m = tp_lib.all_max(logits.detach().amax(dim=-1), rt.group)
    se = tp_lib.sum_shards(torch.exp(logits - m[..., None]).sum(dim=-1),
                           rt.group)
    ids = labels.clamp_min(0).long() - rt.tp_rank * Vl
    inside = (ids >= 0) & (ids < Vl)
    g = torch.gather(logits, -1, ids.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = tp_lib.sum_shards(torch.where(inside, g, torch.zeros_like(g)),
                             rt.group)
    return m + torch.log(se), gold


# ------------------------------------------------------------- input specs

def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """``meta`` tensors standing in for every model input of a cell.

    train:   tokens+labels (B, S)  [+ modality context]
    prefill: tokens (B, S)         [+ modality context]
    decode:  tokens (B, 1) + pos scalar + caches (one dict per layer)
    """
    B, S = shape.global_batch, shape.seq_len
    meta = torch.device("meta")

    def i32(shp):
        return torch.empty(shp, dtype=torch.int32, device=meta)

    def act(shp):
        return torch.empty(shp, dtype=cfg.dtype_torch, device=meta)

    def modality(seq_len):
        extra = {}
        if cfg.is_encdec:               # audio frames, same length as text
            extra["enc_frames"] = act((B, seq_len, cfg.d_model))
        if cfg.frontend == "image_patches":
            extra["img_embeds"] = act((B, cfg.num_image_tokens, cfg.d_model))
        return extra

    if shape.kind == "train":
        return {"tokens": i32((B, S)), "labels": i32((B, S)), **modality(S)}
    if shape.kind == "prefill":
        return {"tokens": i32((B, S)), **modality(S)}
    if shape.kind == "decode":
        enc_len = S if cfg.is_encdec else (
            cfg.num_image_tokens if cfg.frontend == "image_patches" else 0)
        # cross-attention KV (whisper/vision) lives pre-projected in caches,
        # so decode needs no ctx input.
        return {"tokens": i32((B, 1)), "pos": i32(()),
                "caches": init_caches(cfg, B, S, enc_len, device=meta)}
    raise ValueError(shape.kind)
