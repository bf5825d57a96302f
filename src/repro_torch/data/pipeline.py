"""Deterministic synthetic data — counterpart of
``repro/data/pipeline.py``: the LM batches (``lm_batch``,
``make_lm_loader``), the dense low-rank matrix, the Erdős–Rényi matrix in
dense and sparse storage, the streaming ingest generator, and the
video-like and bag-of-words-like matrices.

An LM batch is a pure function of (seed, step): no iterator state to
checkpoint, and a restart replays identical batches.  Tasks: "copy" (the
second half of each sequence repeats the first: learnable, so training
visibly descends), "markov" (an order-1 chain over a fixed transition
table: a stationary cross-entropy floor) and uniform tokens (any other
name).  Each batch draws from a ``torch.Generator`` seeded with
``models.common.fold_in(seed, step)`` (splitmix64), on the batch's device;
the Markov table comes from the fixed seed 7 alone, as the reference's
from ``PRNGKey(7)``, and is the port's own table, not the reference's.

torch's generators do not reproduce ``jax.random``'s streams, so the same
seed gives a different matrix than the reference: parity is distributional,
and the parity tests feed both packages the same numpy arrays instead.

Every generator draws on its ``torch.Generator``'s device (or, for the
stream generators, which take an integer seed as the reference does, on
``device``: ``cuda`` unless the caller asks for the CPU), and the same
seed gives the same matrix.  Large matrices are built in place, one chunk
of rows at a time, so a generator's peak is its output plus chunk-sized
temporaries (the reference's expressions would hold two or three m×n
arrays at once: 112–168 GB at the paper's Video shape).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import fold_in
from repro_torch.util.device import make_generator, resolve_device

# ------------------------------------------------------------------ LM data

#: the seed of the Markov task's transition table (the reference's
#: ``PRNGKey(7)``): the same table for every seed and step
MARKOV_TABLE_SEED = 7


def _lm_generator(seed: int, step: int, device) -> torch.Generator:
    return make_generator(device, fold_in(int(seed), int(step)))


def _markov_table(vocab: int, device) -> torch.Tensor:
    gen = make_generator(device, MARKOV_TABLE_SEED)
    return torch.randn((vocab, vocab), generator=gen, device=device) * 2.0


def lm_batch(seed: int, step: int, *, batch: int, seq: int, vocab: int,
             task: str = "copy", device=None) -> dict:
    """{"tokens", "labels"}, each (batch, seq) int32 on ``device`` (cuda
    unless the caller asks for the CPU): the next-token targets of one
    (batch, seq + 1) draw, a pure function of (seed, step)."""
    dev = resolve_device(device)
    gen = _lm_generator(seed, step, dev)
    if task == "copy":
        half = seq // 2
        first = torch.randint(0, vocab, (batch, half), generator=gen,
                              device=dev)
        toks = torch.cat([first, first], dim=1)
        if toks.shape[1] < seq + 1:
            pad = torch.randint(0, vocab, (batch, seq + 1 - toks.shape[1]),
                                generator=_lm_generator(
                                    fold_in(int(seed), int(step)), 1, dev),
                                device=dev)
            toks = torch.cat([toks, pad], dim=1)
    elif task == "markov":
        logits = _markov_table(vocab, dev)
        cur = torch.randint(0, vocab, (batch,), generator=gen, device=dev)
        cols = [cur]
        for _ in range(seq):
            # Gumbel-max: a categorical draw from each row's logits
            u = torch.rand((batch, vocab), generator=gen, device=dev)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            cur = torch.argmax(logits[cur] + gumbel, dim=-1)
            cols.append(cur)
        toks = torch.stack(cols, dim=1)
    else:
        toks = torch.randint(0, vocab, (batch, seq + 1), generator=gen,
                             device=dev)
    toks = toks.to(torch.int32)
    return {"tokens": toks[:, :seq].contiguous(),
            "labels": toks[:, 1:seq + 1].contiguous()}


def make_lm_loader(cfg, shape, *, seed: int = 0, task: str = "copy",
                   device=None):
    """``batch_fn(step)``: the full input dict of an arch for ``shape``
    (``global_batch`` × ``seq_len``), the modality stubs included
    (``enc_frames`` / ``img_embeds``, 0.1 · normal in the activation
    dtype, drawn from ``fold_in(seed + 1, step)``), on ``device``."""
    dev = resolve_device(device)

    def batch_fn(step):
        step = int(step)
        b = lm_batch(seed, step, batch=shape.global_batch,
                     seq=shape.seq_len, vocab=cfg.vocab, task=task,
                     device=dev)
        gen = _lm_generator(seed + 1, step, dev)
        if cfg.is_encdec:
            b["enc_frames"] = (0.1 * torch.randn(
                (shape.global_batch, shape.seq_len, cfg.d_model),
                generator=gen, device=dev)).to(cfg.dtype_torch)
        if cfg.frontend == "image_patches":
            b["img_embeds"] = (0.1 * torch.randn(
                (shape.global_batch, cfg.num_image_tokens, cfg.d_model),
                generator=gen, device=dev)).to(cfg.dtype_torch)
        return b
    return batch_fn


# ----------------------------------------------------------------- NMF data

#: elements per chunk while building a matrix (a 256 MiB fp32 temporary)
_CHUNK_ELEMS = 1 << 26


def _chunk_rows(n: int) -> int:
    return max(1, _CHUNK_ELEMS // max(1, n))


def _lowrank_rows(generator: torch.Generator, m: int, n: int, k: int,
                  dtype, add) -> torch.Tensor:
    """A (m, n) = W H with W (m, k), H (k, n) uniform on [0, 1) (drawn in
    that order), built a chunk of rows at a time; ``add(blk)`` adds a
    chunk's extra term in place (drawn from ``generator``) before the chunk
    is written into A."""
    dev = generator.device
    W = torch.rand((m, k), generator=generator, device=dev)
    H = torch.rand((k, n), generator=generator, device=dev)
    A = torch.empty((m, n), dtype=dtype, device=dev)
    rows = _chunk_rows(n)
    for r0 in range(0, m, rows):
        blk = W[r0:r0 + rows] @ H
        add(blk)
        A[r0:r0 + rows] = blk
    return A


def lowrank_matrix(generator: torch.Generator, m: int, n: int, k: int, *,
                   noise: float = 0.0, dtype=torch.float32) -> torch.Tensor:
    """Paper §6.1.1 dense synthetic: A = W H + noise·U with W (m, k),
    H (k, n) and U (m, n) uniform on [0, 1), on the generator's device.

    W H and the noise of a chunk are formed in fp32 and written into A's
    rows, so the only temporaries are chunk-sized.  The noise is drawn
    chunk by chunk (2^26 elements each), so the same seed gives the same A
    for the same shape.
    """
    def add(blk):
        if noise:
            U = torch.empty_like(blk).uniform_(generator=generator)
            blk.add_(U, alpha=noise)

    return _lowrank_rows(generator, m, n, k, dtype, add)


def _erdos_renyi_sample(generator: torch.Generator, m: int, n: int,
                        density: float):
    """The one Erdős–Rényi sampler both storage variants draw from, so the
    same generator state gives the same matrix in dense and sparse form:
    (the sorted linear indices i·n + j of the nonzeros, their fp32 values).

    The reference draws a dense (m, n) mask, which is impossible at the
    sizes the sparse path runs (2^24 × 2^24).  This draws round(density ·
    m · n) distinct linear indices uniformly (the first that many distinct
    values of an i.i.d. uniform sequence: draw what is missing, drop the
    repeats, until none is missing), the reference's expected count, and
    a value uniform on (0, 1] for each: no stored value is 0, because
    zero-valued triplets are the sparse layout's padding.
    """
    dev = generator.device
    total = m * n
    target = min(total, round(density * total))
    idx = torch.empty((0,), dtype=torch.int64, device=dev)
    while idx.numel() < target:
        draw = torch.randint(0, total, (target - idx.numel(),),
                             generator=generator, device=dev)
        idx = torch.unique(torch.cat((idx, draw)), sorted=True)
        del draw
    vals = 1.0 - torch.rand(idx.numel(), generator=generator, device=dev)
    return idx, vals


def erdos_renyi_matrix(generator: torch.Generator, m: int, n: int,
                       density: float, dtype=torch.float32) -> torch.Tensor:
    """Paper §6.1.1 sparse synthetic in DENSE storage (zeros off the
    pattern), on the generator's device: the same entries, for the same
    generator state, as :func:`erdos_renyi_bcoo`."""
    idx, vals = _erdos_renyi_sample(generator, m, n, density)
    A = torch.zeros((m, n), dtype=dtype, device=generator.device)
    A.view(-1)[idx] = vals.to(dtype)
    return A


def erdos_renyi_bcoo(generator: torch.Generator, m: int, n: int,
                     density: float, dtype=torch.float32) -> torch.Tensor:
    """Paper §6.1.1 sparse synthetic in sparse storage: an Erdős–Rényi
    (m, n) matrix as a coalesced ``torch.sparse_coo_tensor`` (PyTorch's
    counterpart of BCOO), made on the generator's device, its triplets in
    row-major order (as ``BCOO.fromdense`` orders them).  The sampler is
    :func:`_erdos_renyi_sample`'s, shared with :func:`erdos_renyi_matrix`.
    """
    idx, vals = _erdos_renyi_sample(generator, m, n, density)
    indices = torch.stack((idx // n, idx % n))
    del idx
    return torch.sparse_coo_tensor(indices, vals.to(dtype), (m, n),
                                   is_coalesced=True, check_invariants=False)


def _stream_generator(entropy, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``entropy`` (an int or a
    sequence of ints) through numpy's ``SeedSequence``, so (seed, step)
    pairs give independent streams, none of them a plain seed's."""
    seed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return make_generator(device, int(seed) & ((1 << 63) - 1))


def stream_truth(seed: int, n: int, k: int, dtype=torch.float32, *,
                 device=None) -> torch.Tensor:
    """The fixed ground-truth row model a streaming ingest draws from:
    H (k, n) uniform on [0, 1), which depends on ``seed`` only, so every
    step of a stream shares it (and an oracle retraining from scratch sees
    the same planted factors).  On ``device`` (None: ``cuda``)."""
    gen = _stream_generator([seed], resolve_device(device))
    return torch.rand((k, n), generator=gen, device=gen.device, dtype=dtype)


def stream_batch(seed: int, step: int, *, rows: int, n: int, k: int,
                 drift: float = 0.0, noise: float = 0.0, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """One deterministic ingest batch of a streaming NMF workload, (rows,
    n) on ``device`` (None: ``cuda``): ``batch = f(seed, step)`` is pure,
    so replaying a schedule reproduces every batch bit for bit, with no
    iterator state to checkpoint.

    Rows are drawn from the planted model ``X_step @ H_seed``: the mixing
    codes X (rows, k) are fresh per step; H comes from
    :func:`stream_truth` and is shared by every step of the stream.
    ``drift`` > 0 moves the ground truth: step t samples rows from
    ``H + drift·t·H_alt`` (H_alt the truth of seed + 1), the concept-drift
    regime.  ``noise`` adds uniform measurement noise.
    """
    dev = resolve_device(device)
    gen = _stream_generator([seed, step], dev)
    H = stream_truth(seed, n, k, dtype, device=dev)
    if drift:
        H_alt = stream_truth(seed + 1, n, k, dtype, device=dev)
        H = H + (drift * step) * H_alt
    X = torch.rand((rows, k), generator=gen, device=dev, dtype=dtype)
    A = X @ H
    if noise:
        A = A + noise * torch.rand((rows, n), generator=gen, device=dev,
                                   dtype=dtype)
    return A


def video_like_matrix(generator: torch.Generator, m: int, n: int, *,
                      rank: int = 20, motion: float = 0.05,
                      dtype=torch.float32) -> torch.Tensor:
    """Static low-rank background plus sparse 'moving object' outliers
    (the paper's video use case), on the generator's device: the rank-
    ``rank`` background of :func:`lowrank_matrix` (the same draws, so
    ``lowrank_matrix`` on the same generator state gives the background
    itself), and on a Bernoulli(``motion``) share of the entries an object
    value uniform on [0, 1) added.  Built a chunk of rows at a time: the
    peak is A plus chunk-sized temporaries.
    """
    def add(blk):
        mask = torch.rand(blk.shape, generator=generator,
                          device=blk.device) < motion
        obj = torch.rand(blk.shape, generator=generator, device=blk.device)
        blk.add_(obj.mul_(mask))

    return _lowrank_rows(generator, m, n, rank, dtype, add)


def _dirichlet(generator: torch.Generator, alpha: float, shape) -> torch.Tensor:
    """Dirichlet(alpha·1) draws over the last dimension of ``shape``, as
    normalised standard gammas."""
    g = torch._standard_gamma(
        torch.full(shape, alpha, dtype=torch.float32,
                   device=generator.device), generator=generator)
    return g / g.sum(dim=-1, keepdim=True)


def bow_like_matrix(generator: torch.Generator, vocab: int, docs: int, *,
                    topics: int = 20, doc_len: int = 100,
                    dtype=torch.float32) -> torch.Tensor:
    """Bag-of-words-like counts (vocab, docs) — words × docs — on the
    generator's device: Zipf-like word marginals mixed over latent topics
    (topic-word mixtures Dirichlet(0.05), document-topic mixtures
    Dirichlet(0.3)), each document's counts Poisson(doc_len · its word
    probabilities).  Built a chunk of documents at a time."""
    topic_word = _dirichlet(generator, 0.05, (topics, vocab))      # (T, V)
    doc_topic = _dirichlet(generator, 0.3, (docs, topics))         # (D, T)
    out = torch.empty((vocab, docs), dtype=dtype, device=generator.device)
    step = _chunk_rows(vocab)
    for d0 in range(0, docs, step):
        probs = doc_topic[d0:d0 + step] @ topic_word               # (d, V)
        counts = torch.poisson(doc_len * probs, generator=generator)
        out[:, d0:d0 + step] = counts.T
    return out
