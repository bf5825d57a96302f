"""The benchmark's inputs, made from ``--seed`` on the run's device.

Frozen copies of the port's data generators as they stood when the
benchmark was written (``video_like_matrix`` and the Erdős–Rényi sampler
of ``repro_torch/data/pipeline.py``): a later change to the program cannot
change what the benchmark feeds it.  Every input comes from a
``torch.Generator`` on the device, in a few large calls, chunk by chunk of
rows where a whole temporary would not fit beside the output.

A configuration file names its generator (``"generator"``) and its
parameters; ``make_inputs`` returns the data matrix (dense, or its COO
triplets) and the starting factors, the same for both the program and the
plain reference.
"""

from __future__ import annotations

import torch

#: elements per chunk of rows while building a dense matrix (a 256 MiB
#: fp32 temporary)
CHUNK_ELEMS = 1 << 26

#: independent streams drawn from one seed
STREAM_DATA, STREAM_FACTORS = 0, 1


def generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one stream of ``seed`` (any whole number
    that fits 63 bits once mixed; seeds past 2**31 are fine)."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9)
    return torch.Generator(device=device).manual_seed(mixed % (1 << 63))


def chunk_rows(n: int) -> int:
    return max(1, CHUNK_ELEMS // max(1, n))


def video_like(gen: torch.Generator, m: int, n: int, *, rank: int,
               motion: float) -> torch.Tensor:
    """A static rank-``rank`` background W·H (W (m, rank), H (rank, n)
    uniform on [0, 1), drawn in that order) plus, on a Bernoulli(``motion``)
    share of the entries, an object value uniform on [0, 1): the paper's
    video use case.  fp32, built a chunk of rows at a time."""
    dev = gen.device
    W = torch.rand((m, rank), generator=gen, device=dev)
    H = torch.rand((rank, n), generator=gen, device=dev)
    A = torch.empty((m, n), dtype=torch.float32, device=dev)
    rows = chunk_rows(n)
    for r0 in range(0, m, rows):
        blk = W[r0:r0 + rows] @ H
        mask = torch.rand(blk.shape, generator=gen, device=dev) < motion
        obj = torch.rand(blk.shape, generator=gen, device=dev)
        blk.add_(obj.mul_(mask))
        A[r0:r0 + rows] = blk
        del blk, mask, obj
    return A


def erdos_renyi(gen: torch.Generator, m: int, n: int, nnz: int):
    """An Erdős–Rényi (m, n) pattern of exactly ``nnz`` distinct positions
    (the first that many distinct values of an i.i.d. uniform sequence of
    linear indices: draw what is missing, drop repeats, until none is),
    each with a value uniform on (0, 1].  Returns (indices (2, nnz) int64
    in row-major order, values (nnz,) fp32)."""
    dev = gen.device
    total = m * n
    if not 0 < nnz <= total:
        raise ValueError(f"nnz {nnz} outside (0, {total}]")
    idx = torch.empty((0,), dtype=torch.int64, device=dev)
    while idx.numel() < nnz:
        draw = torch.randint(0, total, (nnz - idx.numel(),), generator=gen,
                             device=dev)
        idx = torch.unique(torch.cat((idx, draw)), sorted=True)
        del draw
    vals = 1.0 - torch.rand(nnz, generator=gen, device=dev)
    indices = torch.empty((2, nnz), dtype=torch.int64, device=dev)
    torch.div(idx, n, rounding_mode="floor", out=indices[0])
    torch.remainder(idx, n, out=indices[1])
    return indices, vals


def make_inputs(cfg: dict, traffic: dict, seed: int,
                device: torch.device) -> dict:
    """{"A": dense (m, n) fp32} or {"indices", "values"} (COO triplets), and
    the starting factors "W0" (m, k) and "H0" (k, n): H0 uniform on
    [0, 1) (the paper's §6.1.3 start), W0 uniform on [0.1, 1) where the
    traffic's rule needs a positive start (``"w0": "positive"``), else 0."""
    m, n, k = cfg["m"], cfg["n"], cfg["k"]
    gen = generator(device, seed, STREAM_DATA)
    kind = cfg["generator"]
    if kind == "video_like":
        out = {"A": video_like(gen, m, n, rank=cfg["assumed"]["rank"],
                               motion=cfg["assumed"]["motion"])}
    elif kind == "erdos_renyi":
        indices, values = erdos_renyi(gen, m, n, cfg["nnz"])
        out = {"indices": indices, "values": values}
    else:
        raise ValueError(f"unknown generator {kind!r}")
    fgen = generator(device, seed, STREAM_FACTORS)
    out["H0"] = torch.rand((k, n), generator=fgen, device=device)
    if traffic["w0"] == "positive":
        out["W0"] = torch.empty((m, k), device=device).uniform_(
            0.1, 1.0, generator=fgen)
    elif traffic["w0"] == "zeros":
        out["W0"] = torch.zeros((m, k), device=device)
    else:
        raise ValueError(f"unknown w0 {traffic['w0']!r}")
    return out
