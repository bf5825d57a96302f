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
plain reference.  ``erdos_renyi_tiled`` draws a fixed T × T tiling of the
matrix tile by tile, each tile from a stream of its own, so that a rank of
a grid draws only its block's tiles and every grid reads the same matrix.
"""

from __future__ import annotations

import torch

#: elements per chunk of rows while building a dense matrix (a 256 MiB
#: fp32 temporary)
CHUNK_ELEMS = 1 << 26

#: independent streams drawn from one seed; tile (a, b) of a T × T tiling
#: draws from stream STREAM_TILE0 + a·T + b
STREAM_DATA, STREAM_FACTORS, STREAM_TILE0 = 0, 1, 2


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


def tile_nnz(nnz: int, tiles: int, t: int) -> int:
    """Tile ``t``'s share of ``nnz`` on a ``tiles`` × ``tiles`` tiling of
    equal tiles: the same share each (shares by area), the remainder one
    apiece to the tiles of lowest index."""
    base, rem = divmod(nnz, tiles * tiles)
    return base + (t < rem)


def erdos_renyi_tiled(device: torch.device, seed: int, m: int, n: int,
                      nnz: int, tiles: int, grid=(1, 1), block=(0, 0)):
    """Block ``block`` of a ``grid`` of an Erdős–Rényi (m, n) pattern drawn
    on a fixed ``tiles`` × ``tiles`` tiling: tile (a, b) holds exactly
    ``tile_nnz`` distinct positions with values uniform on (0, 1], drawn
    by ``erdos_renyi`` from stream ``STREAM_TILE0 + a·tiles + b`` of
    ``seed``.  A block is a whole number of tiles (each grid dimension
    divides ``tiles``), so every grid reads the same matrix bit for bit.
    Returns (indices (2, nnz of the block) int64 of the global matrix in
    row-major order, values (…,) fp32)."""
    (pr, pc), (i, j) = grid, block
    if m % tiles or n % tiles or tiles % pr or tiles % pc:
        raise ValueError(f"a {tiles}-tile tiling of {m} × {n} on a {pr} × "
                         f"{pc} grid: m and n must divide by the tiles, the "
                         f"tiles by each grid dimension")
    tm, tn = m // tiles, n // tiles
    ra, cb = tiles // pr, tiles // pc
    index_parts, value_parts = [], []
    for a in range(i * ra, (i + 1) * ra):
        band_index, band_values = [], []
        for b in range(j * cb, (j + 1) * cb):
            t = a * tiles + b
            share = tile_nnz(nnz, tiles, t)
            if share == 0:
                continue
            idx, vals = erdos_renyi(
                generator(device, seed, STREAM_TILE0 + t), tm, tn, share)
            idx[0] += a * tm
            idx[1] += b * tn
            band_index.append(idx)
            band_values.append(vals)
        if not band_index:
            continue
        idx, vals = torch.cat(band_index, 1), torch.cat(band_values)
        del band_index, band_values
        if cb > 1:                  # the band's tiles share rows: row-major
            order = torch.argsort(idx[0] * n + idx[1])
            idx, vals = idx[:, order], vals[order]
            del order
        index_parts.append(idx)
        value_parts.append(vals)
    if not index_parts:
        return (torch.empty((2, 0), dtype=torch.int64, device=device),
                torch.empty((0,), dtype=torch.float32, device=device))
    return torch.cat(index_parts, 1), torch.cat(value_parts)


def starting_factors(cfg: dict, traffic: dict, seed: int,
                     device: torch.device, block=None) -> dict:
    """The starting factors "W0" (m, k) and "H0" (k, n) from the seed's
    ``STREAM_FACTORS``: H0 uniform on [0, 1) (the paper's §6.1.3 start),
    W0 uniform on [0.1, 1) where the traffic's rule needs a positive start
    (``"w0": "positive"``), else 0.  With ``block`` = (W's rows, H's
    columns), two slices, only those: "W0" (rows, k) and "Ht0" (columns,
    k), each drawn whole and cut before the next is drawn."""
    m, n, k = cfg["m"], cfg["n"], cfg["k"]
    fgen = generator(device, seed, STREAM_FACTORS)
    H0 = torch.rand((k, n), generator=fgen, device=device)
    out = ({"H0": H0} if block is None
           else {"Ht0": H0[:, block[1]].T.contiguous()})
    del H0
    if traffic["w0"] == "positive":
        W0 = torch.empty((m, k), device=device).uniform_(
            0.1, 1.0, generator=fgen)
    elif traffic["w0"] == "zeros":
        W0 = torch.zeros((m, k), device=device)
    else:
        raise ValueError(f"unknown w0 {traffic['w0']!r}")
    out["W0"] = W0 if block is None else W0[block[0]].clone()
    return out


def make_inputs(cfg: dict, traffic: dict, seed: int, device: torch.device,
                grid=(1, 1), block=(0, 0)) -> dict:
    """{"A": dense (m, n) fp32} or {"indices", "values"} (COO triplets), and
    the starting factors (``starting_factors``).  ``grid`` and ``block``
    (a tiled generator only) draw the triplets of one block of a grid."""
    m, n = cfg["m"], cfg["n"]
    kind = cfg["generator"]
    if kind != "erdos_renyi_tiled" and tuple(grid) != (1, 1):
        raise ValueError(f"generator {kind!r} draws the whole matrix; a "
                         f"{grid[0]} × {grid[1]} grid needs a tiled one")
    if kind == "video_like":
        gen = generator(device, seed, STREAM_DATA)
        out = {"A": video_like(gen, m, n, rank=cfg["assumed"]["rank"],
                               motion=cfg["assumed"]["motion"])}
    elif kind == "erdos_renyi":
        gen = generator(device, seed, STREAM_DATA)
        indices, values = erdos_renyi(gen, m, n, cfg["nnz"])
        out = {"indices": indices, "values": values}
    elif kind == "erdos_renyi_tiled":
        indices, values = erdos_renyi_tiled(device, seed, m, n, cfg["nnz"],
                                            cfg["tiles"], grid, block)
        out = {"indices": indices, "values": values}
    else:
        raise ValueError(f"unknown generator {kind!r}")
    out.update(starting_factors(cfg, traffic, seed, device))
    return out
