"""α-β-γ communication/computation cost model (paper §2.2, §5, Table III).
Counterpart of ``repro/core/costmodel.py``, formula for formula.

Costs are per iteration.  ``F(m, n, k)`` is the algorithm-specific LUC flop
count (paper §4), supplied per rule by ``UpdateRule.luc_flops``: 2(m+n)k²
for MU/HALS (× the inner budget for the accelerated variants);
data-dependent O(k³..k⁴) per column for BPP — the paper's symbolic form
plus an empirical knob.  Rules also declare their own collectives via
``UpdateRule.extra_latency_words`` — the HALS family's per-column norm
all-reduces are the k·log p latency term of the paper's Table — which the
distributed schedule costs add on top of the matrix-product collectives.
``algo`` everywhere accepts a registered name or an ``UpdateRule``
instance, so custom rules' cost hooks flow through unchanged.

``NMFSolver.predict_cost`` / ``predict_cost_terms`` read the schedule's
grid (faun, gspmd: pr × pc; naive: p × 1) and call ``schedule_cost`` /
``schedule_cost_terms`` here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core import rules as _rules


@dataclass(frozen=True)
class Machine:
    """α latency (s/message), β inverse bandwidth (s/word), γ (s/flop).

    Default constants approximate the paper's "Rhea" cluster (FDR IB,
    Sandy Bridge) for the model-vs-paper comparisons.
    """
    alpha: float = 1e-6
    beta: float = 1.4e-10        # ≈ 56 Gb/s FDR / 8 bytes-per-word
    gamma: float = 7.5e-12       # ≈ 133 Gflop/s per 16-core node / 16

    def collective_words(self, kind: str, n_words: float, p: int) -> float:
        """Wire words per processor for optimal collectives (paper §2.3)."""
        if p <= 1:
            return 0.0
        frac = (p - 1) / p
        return {"all_gather": frac * n_words,
                "reduce_scatter": frac * n_words,
                "all_reduce": 2 * frac * n_words}[kind]

    def collective_time(self, kind: str, n_words: float, p: int) -> float:
        if p <= 1:
            return 0.0
        lat = {"all_gather": 1, "reduce_scatter": 1, "all_reduce": 2}[kind]
        return lat * self.alpha * math.log2(p) + \
            self.beta * self.collective_words(kind, n_words, p)


def luc_flops(algo: "_rules.RuleSpec", m: int, n: int, k: int, *,
              bpp_iters: float = 1.0) -> float:
    """F(m, n, k) of Table III — the rule's ``luc_flops`` hook.  For BPP the
    paper leaves C_BPP symbolic; the built-in rule models it as `bpp_iters`
    passes of a k×k solve per column (empirically 1–3 rounds dominate)."""
    return _rules.get_rule(algo).luc_flops(m, n, k, bpp_iters=bpp_iters)


@dataclass(frozen=True)
class IterCost:
    flops: float
    words: float                  # communication (wire) words
    messages: float
    memory_words: float           # resident storage footprint
    #: HBM words the local A-products move per iteration (the backend's
    #: ``mm_traffic_words``) — the locality term the sorted SpMM layout
    #: improves: the scatter impl re-reads and re-writes an output row per
    #: nonzero, the sorted impl streams each output tile once.  Not part of
    #: ``time`` (α-β-γ models wire, not HBM); reported for roofline use.
    traffic_words: float = 0.0

    def time(self, mach: Machine) -> float:
        return (mach.gamma * self.flops + mach.beta * self.words
                + mach.alpha * self.messages)


def _resolve_ops(backend, dense: bool):
    """Map the (backend, legacy ``dense`` flag) pair to a LocalOps instance,
    whose mm_flops/storage_words parameterise the formulas below."""
    from repro_torch.backends import get_backend
    if backend is not None:
        return get_backend(backend)
    return get_backend("dense" if dense else "sparse")


def serial_cost(m: int, n: int, k: int, *, algo: str = "bpp",
                dense: bool = True, nnz: float = 0.0,
                bpp_iters: float = 1.0, backend=None) -> IterCost:
    """Single-device baseline (p = 1): all flops, no communication."""
    ops = _resolve_ops(backend, dense)
    gram_flops = (m + n) * k * k
    flops = ops.mm_flops(m, n, k, nnz=nnz) + gram_flops \
        + luc_flops(algo, m, n, k, bpp_iters=bpp_iters)
    mem = ops.storage_words(m, n, nnz=nnz) + (m + n) * k
    return IterCost(flops, 0.0, 0.0, mem,
                    ops.mm_traffic_words(m, n, k, nnz=nnz))


def schedule_cost(schedule: str, m: int, n: int, k: int, *, pr: int = 1,
                  pc: int = 1, algo: str = "bpp", dense: bool = True,
                  nnz: float = 0.0, bpp_iters: float = 1.0,
                  backend=None, compression: str | None = None) -> IterCost:
    """One entry point for every engine schedule, threading nnz through.

    ``backend`` is a ``repro_torch.backends`` name or LocalOps instance; its
    ``mm_flops`` (dense 4·m·n·k vs sparse 4·nnz·k per iteration),
    ``storage_words``, and ``mm_traffic_words`` (e.g. the sorted SpMM
    layout's streamed-output traffic vs the scatter impl's per-nonzero
    read-modify-write — ``SparseOps(spmm_impl="sorted")``) keep the
    prediction honest per backend.  The legacy ``dense=False`` spelling
    maps to the sparse backend.

    ``gspmd`` is modelled with the FAUN formulas — its *optimal* schedule —
    so a measured gap reads directly as the sharding propagation's
    overhead against this prediction.

    The rule's own collectives (``UpdateRule.extra_latency_words``: the
    HALS family's k·log p per-column norm reductions, the accelerated
    rules' stall-norm all-reduces) are charged on top of the schedule's
    matrix-product collectives.

    ``compression="int8"`` scales the panel words by the int8/fp32 ratio
    (¼) and adds the fp32 scale-vector sidecars + pmax reductions, matching
    the wire format of ``NMFSolver(panel_compression="int8")`` (see
    ``repro_torch.distributed.compression``; serial has no collectives, so
    compression is a no-op there).
    """
    schedule = schedule.lower()
    if schedule == "serial":
        return serial_cost(m, n, k, algo=algo, dense=dense, nnz=nnz,
                           bpp_iters=bpp_iters, backend=backend)
    if schedule in ("faun", "gspmd"):
        return mpifaun_cost(m, n, k, pr, pc, algo=algo, dense=dense, nnz=nnz,
                            bpp_iters=bpp_iters, backend=backend,
                            compression=compression)
    if schedule == "naive":
        return naive_cost(m, n, k, pr * pc, algo=algo, dense=dense, nnz=nnz,
                          bpp_iters=bpp_iters, backend=backend,
                          compression=compression)
    raise ValueError(f"unknown schedule {schedule!r}")


def mpifaun_cost(m: int, n: int, k: int, pr: int, pc: int, *,
                 algo: str = "bpp", dense: bool = True, nnz: float = 0.0,
                 bpp_iters: float = 1.0, backend=None,
                 compression: str | None = None) -> IterCost:
    """Per-iteration cost of Algorithm 3 (paper §5.2.1–5.2.3).

    With ``compression="int8"`` the four panel collectives ship int8
    payloads (¼ of the fp32 words) plus a per-row fp32 scale sidecar:
    all-gathers gather the sidecar alongside (one scale word per gathered
    row), reduce-scatters share theirs via a pmax all-reduce (2× the
    gather's sidecar words).  The two k×k Gram all-reduces move the same
    word count as exact (int32 payload) plus a pmax of their k-row scales;
    every compressed collective splits into payload + sidecar, doubling the
    message term.  The k-word column-scale pmax each collective also ships
    is negligible against the row sidecars and is not modelled.
    """
    ops = _resolve_ops(backend, dense)
    p = pr * pc
    mm_flops = ops.mm_flops(m, n, k, nnz=nnz) / p
    gram_flops = (m + n) * k * k / p
    flops = mm_flops + gram_flops + luc_flops(algo, m / p, n / p, k,
                                              bpp_iters=bpp_iters)
    # words: 2 all-reduces of k², 2 all-gathers + 2 reduce-scatters of panels
    gram_words = 2 * 2 * k * k * (p - 1) / p
    panel_h = (pr - 1) * n * k / p        # all-gather Ht / reduce-scatter WᵀA
    panel_w = (pc - 1) * m * k / p        # all-gather W / reduce-scatter AHᵀ
    if compression is None:
        words = gram_words + 2 * (panel_h + panel_w)
        messages = 6 * math.log2(max(p, 2))
    else:
        from repro_torch.distributed.compression import compressed_words
        words = (gram_words + 2 * 2 * k * (p - 1) / p      # + gram scale pmax
                 + compressed_words(panel_h, rows=(pr - 1) * n / p)
                 + compressed_words(panel_w, rows=(pc - 1) * m / p)
                 + compressed_words(panel_w, rows=(pc - 1) * m / p,
                                    scatter=True)
                 + compressed_words(panel_h, rows=(pr - 1) * n / p,
                                    scatter=True))
        messages = 12 * math.log2(max(p, 2))
    # ... plus the rule's own collectives (HALS: k·log p column norms)
    extra_msgs, extra_words = _rules.get_rule(algo).extra_latency_words(k, p)
    mem = ops.storage_words(m, n, nnz=nnz) / p + (m + n) * k / p \
        + 2 * m * k / pr + 2 * n * k / pc
    return IterCost(flops, words + extra_words, messages + extra_msgs, mem,
                    ops.mm_traffic_words(m, n, k, nnz=nnz) / p)


def naive_cost(m: int, n: int, k: int, p: int, *, algo: str = "bpp",
               dense: bool = True, nnz: float = 0.0,
               bpp_iters: float = 1.0, backend=None,
               compression: str | None = None) -> IterCost:
    """Per-iteration cost of Algorithm 2 (paper §5.1.1–5.1.3).

    ``compression="int8"`` quarters the two full-factor all-gathers' words
    and adds one fp32 scale word per gathered row (no reduce-scatters here,
    so no pmax sidecars); payload + sidecar doubles the message term.
    """
    ops = _resolve_ops(backend, dense)
    mm_flops = ops.mm_flops(m, n, k, nnz=nnz) / p
    gram_flops = (m + n) * k * k          # redundant on every processor
    flops = mm_flops + gram_flops + luc_flops(algo, m / p, n / p, k,
                                              bpp_iters=bpp_iters)
    words = (m + n) * k * (p - 1) / p     # two full-factor all-gathers
    messages = 2 * math.log2(max(p, 2))
    if compression is not None:
        from repro_torch.distributed.compression import compressed_words
        words = compressed_words(words, rows=(m + n) * (p - 1) / p)
        messages *= 2
    extra_msgs, extra_words = _rules.get_rule(algo).extra_latency_words(k, p)
    mem = 2.0 * ops.storage_words(m, n, nnz=nnz) / p + (m + n) * k
    return IterCost(flops, words + extra_words, messages + extra_msgs, mem,
                    ops.mm_traffic_words(m, n, k, nnz=nnz) / p)


def schedule_cost_terms(schedule: str, m: int, n: int, k: int, *,
                        pr: int = 1, pc: int = 1, algo: str = "bpp",
                        dense: bool = True, nnz: float = 0.0,
                        bpp_iters: float = 1.0, backend=None,
                        compression: str | None = None,
                        machine: Machine | None = None) -> dict[str, float]:
    """Per-phase-group predicted seconds — the join key for the measured
    breakdown of ``NMFSolver.fit(profile=True)`` (``obs/report.py``).

    Returns ``{"gram", "mm", "luc", "comm", "error"}`` where the first four
    partition the model exactly: ``gram + mm + luc + comm ==
    schedule_cost(...).time(machine)`` (comm is β·words + α·messages, i.e.
    the time total minus γ·flops).  ``error`` models the convergence-check
    byproduct (one extra k×k Gram of the H block) which ``IterCost`` does
    not charge — it is informational, outside the partition.
    """
    mach = machine or Machine()
    sched = schedule.lower()
    total = schedule_cost(sched, m, n, k, pr=pr, pc=pc, algo=algo,
                          dense=dense, nnz=nnz, bpp_iters=bpp_iters,
                          backend=backend, compression=compression)
    ops = _resolve_ops(backend, dense)
    p = 1 if sched == "serial" else pr * pc
    mm_f = ops.mm_flops(m, n, k, nnz=nnz) / p
    # naive recomputes both k×k Grams redundantly on every processor
    gram_f = (m + n) * k * k if sched == "naive" else (m + n) * k * k / p
    luc_f = luc_flops(algo, m / p, n / p, k, bpp_iters=bpp_iters)
    comm = max(total.time(mach) - mach.gamma * (mm_f + gram_f + luc_f), 0.0)
    return {"gram": mach.gamma * gram_f,
            "mm": mach.gamma * mm_f,
            "luc": mach.gamma * luc_f,
            "comm": comm,
            "error": mach.gamma * n * k * k / p}


def optimal_grid(m: int, n: int, p: int) -> tuple[int, int]:
    """Paper §5.2.2: pr/pc ≈ m/n subject to pr·pc = p (integer search), with
    the 1-D degenerate cases when one dimension dominates."""
    if m / p >= n:
        return p, 1
    if n / p >= m:
        return 1, p
    best, best_cost = (p, 1), float("inf")
    for pr in range(1, p + 1):
        if p % pr:
            continue
        pc = p // pr
        cost = (pr - 1) * n / p + (pc - 1) * m / p   # panel words / k
        if cost < best_cost:
            best, best_cost = (pr, pc), cost
    return best


def bandwidth_lower_bound_words(m: int, n: int, k: int, p: int) -> float:
    """Ω(min{√(mnk²/p), nk}) (Theorem 5.1, m ≥ n)."""
    return min(math.sqrt(m * n * k * k / p), n * k)
