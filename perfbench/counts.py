"""The work each phase of an AU-NMF iteration needs, counted from shapes,
and the least time one H100 could take for it.

Each count is of the operation, whatever implements it: every input byte
read once and every output byte written once, FLOPs as the mathematics
needs them.  The least time of an operation is the larger of its FLOPs at
the TF32 dense rate (the fastest rate that takes fp32 operands, so no
correct implementation can beat it) and its bytes at HBM3's rate.

    dense product  A (m, n) · B (n, k): 2mnk FLOPs; A, B read, out written
    sparse product nnz triplets · B: 2·nnz·k FLOPs; values and column
                   indices read once (8 B a nonzero: no row index, no
                   padding or permutation of a sorted layout), B read
                   once, out written once
    Gram           XᵀX of X (r, k): 2rk² FLOPs; X read, G written
    MU / HALS      X (r, k) from G, R: 2rk² FLOPs (X·G) plus a few a
                   entry; R, X, G read, X written
    BPP            the pivoting rounds depend on the data and are not
                   counted: R and G read and X written, no FLOPs (a lower
                   bound, used only inside the iteration's count)
    error          ‖A − WH‖² from byproducts: the new Hᵀ's Gram, the
                   cross term ⟨AᵀW, Hᵀ⟩ and ⟨WᵀW, HHᵀ⟩; AᵀW and Hᵀ read

On a cell of p chips each phase's least time is the whole problem's count
divided by p: the work split evenly, with nothing counted for the
collectives that move the panels between the chips.  It is a lower bound
there, and the shares read the same work however the grid splits it.
"""

from __future__ import annotations

#: NVIDIA H100 SXM5 data sheet, dense rates: TF32 on the tensor cores
PEAK_TF32_FLOPS = 494.7e12
#: HBM3 bandwidth, bytes a second
PEAK_HBM_BYTES = 3.35e12


def least_ms(flops: float, nbytes: float) -> float:
    return 1e3 * max(flops / PEAK_TF32_FLOPS, nbytes / PEAK_HBM_BYTES)


def dense_product(m: int, n: int, k: int, item: int = 4):
    """A (m, n) · B (n, k) → (m, k): (FLOPs, bytes)."""
    return 2.0 * m * n * k, float(item * (m * n + n * k + m * k))


def sparse_product(nnz: int, n_in: int, m_out: int, k: int, item: int = 4):
    """nnz triplets of an (m_out, n_in) matrix · B (n_in, k)."""
    return 2.0 * nnz * k, float((item + 4) * nnz + item * (n_in + m_out) * k)


def gram(r: int, k: int, item: int = 4):
    return 2.0 * r * k * k, float(item * (r * k + k * k))


def luc(rule: str, r: int, k: int, item: int = 4):
    """One half-update of ``r`` rows; None where the work depends on the
    data (BPP)."""
    if rule in ("mu", "hals"):
        return 2.0 * r * k * k + 4.0 * r * k, float(item * (3 * r * k + k * k))
    return None


def luc_floor(r: int, k: int, item: int = 4):
    """What any half-update must move: R and G read, X written."""
    return 0.0, float(item * (2 * r * k + k * k))


def error(n: int, k: int, item: int = 4):
    return (2.0 * n * k * k + 2.0 * n * k + 2.0 * k * k,
            float(item * (2 * n * k + 2 * k * k)))


def phases(cfg: dict, rule: str) -> dict:
    """(FLOPs, bytes) of each phase key of the serial schedule, None where
    not counted."""
    m, n, k = cfg["m"], cfg["n"], cfg["k"]
    if cfg["storage"] == "dense":
        mm_w, mm_h = dense_product(m, n, k), dense_product(n, m, k)
    else:
        nnz = cfg["nnz"]
        mm_w = sparse_product(nnz, n, m, k)
        mm_h = sparse_product(nnz, m, n, k)
    return {"gram_w": gram(n, k), "mm_w": mm_w, "luc_w": luc(rule, m, k),
            "gram_h": gram(m, k), "mm_h": mm_h, "luc_h": luc(rule, n, k),
            "error": error(n, k)}


#: phase keys of each group a per-layer metric reads
GROUPS = {"mm": ("mm_w", "mm_h"), "gram": ("gram_w", "gram_h"),
          "luc": ("luc_w", "luc_h"), "error": ("error",)}


def least_by_group(cfg: dict, rule: str, chips: int = 1) -> dict:
    """Least ms of each group of phases and of the whole iteration (BPP's
    half-updates there at ``luc_floor``: the iteration's count is then a
    lower bound) on ``chips`` chips; a group holding an uncounted phase is
    None."""
    counted = phases(cfg, rule)
    out = {}
    for group, keys in GROUPS.items():
        parts = [counted[p] for p in keys]
        out[group] = (None if any(p is None for p in parts)
                      else sum(least_ms(*p) for p in parts) / chips)
    floors = {"luc_w": luc_floor(cfg["m"], cfg["k"]),
              "luc_h": luc_floor(cfg["n"], cfg["k"])}
    out["iteration"] = sum(least_ms(*(c if c is not None else floors[p]))
                           for p, c in counted.items()) / chips
    return out
