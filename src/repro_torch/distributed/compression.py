"""Communication compression for the k-width panel collectives.
Counterpart of ``repro/distributed/compression.py``.

Every distributed AU-NMF iteration moves only k-width quantities — the two
k×k Grams and the factor panels (paper Algorithm 3; A never crosses the
wire).  This module compresses those collectives: symmetric int8 linear
quantisation with two-sided fp32 scales — a shared per-column scale (NMF
factor columns span wildly different magnitudes; see ``_col_scale``) under
a per-row scale — reduced in int32 and rescaled.  Error feedback (Seide et
al.; Karimireddy et al. EF21) accumulates each collective's quantisation
residual locally and re-injects it on the next iteration, which is what
makes 8-bit panel exchange converge to the uncompressed fixed point.

The panel API (``Int8PanelCompressor``) is consumed by the schedule bodies
(core/faun.py, core/naive.py, core/gspmd.py) behind
``NMFSolver(..., panel_compression="int8")``.  Where the reference names
mesh axes, the port passes a ``torch.distributed`` process group:

  * ``all_gather``      int8 payload + fp32 row scales on the wire (¼ the
                        panel bytes): two ``all_gather_into_tensor`` calls;
                        column scales shared by a MAX all-reduce.
  * ``reduce_scatter``  row and column scales shared by MAX all-reduces so
                        the int8 payloads are comparable, then one int8
                        ``all_to_all_single`` and a local int32 chunk sum;
                        the reduction itself is exact once quantised.
  * ``allreduce``       the k×k Grams: shared scales, an int32 all-reduce
                        at high resolution (``_GRAM_LEVELS``, not int8 —
                        exact NNLS solvers amplify Gram noise; the int32
                        payload is as wide as fp32 either way).
  * ``simulate``        quantise → dequantise with error feedback and no
                        collective: the gspmd schedule's numerics-only
                        emulation; ``simulate_gram`` at Gram resolution.

The reference's multi-pod grid reduce-scatters in two hops, ("pod", "pr"):
int8 across pods, then int32.  The port folds the pods into the grid rows
(one group of pod·pr ranks, as ``core/faun.py`` does for the exact path)
and runs one int8 hop: integer sums do not depend on their order, so the
one hop lands exactly the reference's two-hop sums.

Residuals are fp32 tensors in every case (also when the factors carry
bf16), one per compressed collective, keyed as the schedules name them;
the engine threads them through its loop as ``(rule_state, residuals)``.
``zero_residuals`` builds an initial carry.

The per-tensor helpers at the bottom (``quantize_int8``,
``compressed_pmean``, ``topk_with_feedback``) are the generic gradient-
compression primitives the panel API grew out of; they map over nested
dicts, lists and tuples of tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

#: valid ``NMFSolver(panel_compression=...)`` values (None = exact)
COMPRESSIONS = ("int8",)

_EPS = 1e-30          # scale guard; rows of exact zeros quantise to zeros

_PANEL_LEVELS = 127.0          # int8 symmetric range for the factor panels
#: Gram quantisation resolution: the k×k Grams ship as int32 anyway (the
#: width of fp32), so they quantise at ~2²³ levels — exact NNLS solvers
#: (BPP) amplify Gram perturbations through the normal-equation solve.
#: 2²³ keeps round(tot/scale) exact in fp32; ``_gram_levels`` caps it so
#: the int32 sum over the group cannot overflow.
_GRAM_LEVELS = float(2 ** 23)

_TINY = torch.finfo(torch.float32).tiny

#: ``_ef_quantize``'s "no group": the scales stay this rank's own (None is
#: torch.distributed's default group)
LOCAL = object()


def _row_scale(tot: torch.Tensor, levels: float = _PANEL_LEVELS
               ) -> torch.Tensor:
    """Per-row fp32 scale of a (rows, k) panel: max|row| / levels."""
    return (torch.amax(torch.abs(tot), dim=tuple(range(1, tot.ndim)))
            / levels + _EPS)


def _col_scale(tot: torch.Tensor) -> torch.Tensor:
    """Per-column fp32 scale of a (rows, k) panel: max|column|.

    Quantisation is two-sided — columns are normalised by this scale before
    the per-row int8 grid is applied — because NMF panel columns span
    wildly different magnitudes: with a row-only scale a weak column sits
    below half a quantisation step of the row maximum and is wiped to zero,
    which kills it under HALS/BPP."""
    return torch.amax(torch.abs(tot), dim=tuple(range(tot.ndim - 1))) + _EPS


def _pmax(v: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of ``v`` over ``group``, as a new tensor."""
    out = v.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _rescale(q: torch.Tensor, rs: torch.Tensor, cs: torch.Tensor):
    """q · rs[:, None] · cs[None, :] in fp32, multiplied in that order in
    place (one panel-sized result)."""
    out = q.float()
    out.mul_(rs[:, None])
    return out.mul_(cs[None, :])


class Int8PanelCompressor:
    """int8 + error-feedback panel collectives over process groups.

    Every method takes the local panel ``x``, the ``group`` to communicate
    over and the carried fp32 ``residual`` of ``x``'s shape; all return
    ``(result_f32, new_residual)``.
    """

    name = "int8"

    # -- error-feedback front end (shared by every collective) --------------

    def _ef_quantize(self, x, residual, *, col_group=LOCAL, row_group=LOCAL,
                     levels: float = _PANEL_LEVELS):
        """Add the carried residual, normalise columns by a shared
        per-column scale (a MAX all-reduce over ``col_group``), pick
        per-row scales (shared over ``row_group`` when the payloads must
        sum across ranks), quantise at ``levels`` resolution, and compute
        the next residual.  Returns ``(q, row_scale, col_scale,
        new_residual)`` with ``deq = q · row_scale[:, None] ·
        col_scale[None, :]``; ``q`` holds integers in fp32.

        A column whose fresh payload is exactly zero drops its carried
        residual: dead factor columns propagate exact zeros through the
        uncompressed iteration (HALS/BPP rely on that), and replaying a
        stale residual into one re-injects noise the solvers then divide
        by an eps-guarded zero.

        The quantisation divides by ONE fused scale floored at the
        smallest normal fp32: for all-zero rows of dead columns the two
        eps-floored scales multiply below it, and 0/0 would be NaN.

        The reference's expressions, each operation in place where that
        gives the same bits, so a (rows, k) panel costs three panel-sized
        temporaries (tot, q, the fused scale) beside its input and the old
        residual."""
        x32 = x.float()
        alive = torch.amax(torch.abs(x32), dim=tuple(range(x.ndim - 1))) > 0
        tot = residual * alive
        tot.add_(x32)                       # x32 + residual·alive
        cs = _col_scale(tot)
        if col_group is not LOCAL:
            cs = _pmax(cs, col_group)
        rs = _row_scale(tot / cs, levels)
        if row_group is not LOCAL:
            rs = _pmax(rs, row_group)
        s = rs.reshape(rs.shape + (1,) * (tot.ndim - 1)) * cs
        s.clamp_min_(_TINY)
        q = tot / s
        q.round_().clamp_(-levels, levels)
        tot.sub_(s.mul_(q))                 # tot − q·s
        return q, rs, cs, tot

    def _gram_levels(self, group) -> float:
        """Gram resolution, capped so the int32 sum over ``group`` cannot
        overflow (levels · p ≤ int32 max)."""
        p = dist.get_world_size(group)
        return float(min(int(_GRAM_LEVELS), (2 ** 31 - 1) // max(p, 1)))

    # -- the three panel collectives ----------------------------------------

    def all_gather(self, x, group, residual):
        """Gather a factor panel along dim 0 in group-rank order: int8
        payload + fp32 row-scale sidecar; the column scales are MAX-shared
        so every rank dequantises alike.  Wire: rows·k bytes + rows scales
        against 4·rows·k bytes exact."""
        q, rs, cs, new_res = self._ef_quantize(x, residual, col_group=group)
        from repro_torch.core.faun import allgather_panel
        g = allgather_panel(q.to(torch.int8), group)
        del q
        s = allgather_panel(rs, group)
        return _rescale(g, s, cs), new_res

    def reduce_scatter(self, x, group, residual):
        """Reduce-scatter a local product along dim 0 (group rank g gets
        rows g·r/size …): scales MAX-shared over ``group`` so the int8
        payloads sum exactly; one int8 all-to-all, then a local int32 sum
        of the chunks."""
        q, rs, cs, new_res = self._ef_quantize(x, residual, col_group=group,
                                               row_group=group)
        p = dist.get_world_size(group)
        rows = x.shape[0]
        if rows % p:
            raise ValueError(f"{rows} rows do not scatter over {p} ranks")
        blk = rows // p
        part = q.to(torch.int8)
        del q
        chunks = torch.empty_like(part)
        dist.all_to_all_single(chunks, part, group=group)
        del part
        # the chunks summed in int32 (exact: at most 127·p), without an
        # int32 copy; a plain int32 sum would widen to int64
        summed = chunks.view((p, blk) + tuple(x.shape[1:])).sum(
            0, dtype=torch.int32)
        del chunks
        off = dist.get_rank(group) * blk
        return _rescale(summed, rs[off:off + blk], cs), new_res

    def allreduce(self, x, group, residual):
        """All-reduce a k×k Gram: shared scales, an int32 sum, rescale.
        The same word count as exact (int32 is fp32's width) plus the
        k-row scale MAX all-reduces: Grams are compressed for numerical
        uniformity (their residuals feed the same error-feedback loop),
        not bandwidth, at ``_GRAM_LEVELS``."""
        levels = self._gram_levels(group)
        q, rs, cs, new_res = self._ef_quantize(x, residual, col_group=group,
                                               row_group=group,
                                               levels=levels)
        tot = q.to(torch.int32)
        dist.all_reduce(tot, group=group)
        return _rescale(tot, rs, cs), new_res

    # -- global-view emulation (gspmd) --------------------------------------

    def simulate(self, x, residual, *, levels: float = _PANEL_LEVELS):
        """Quantise → dequantise with error feedback, no collective: the
        gspmd schedule applies this where the hand schedules' collectives
        sit (the reduced products), reproducing the compressed numerics
        while DTensor keeps ownership of the actual wire."""
        q, rs, cs, new_res = self._ef_quantize(x, residual, levels=levels)
        s = rs.reshape(rs.shape + (1,) * (x.ndim - 1))
        return q * s * cs, new_res

    def simulate_gram(self, x, residual):
        """``simulate`` at Gram resolution — the gspmd analogue of
        ``allreduce``'s high-resolution Gram quantisation."""
        return self.simulate(x, residual, levels=_GRAM_LEVELS)


def get_compressor(name: str) -> Int8PanelCompressor:
    """Resolve a ``panel_compression`` name to a compressor instance."""
    if name not in COMPRESSIONS:
        raise ValueError(f"unknown panel_compression {name!r}; choose from "
                         f"{COMPRESSIONS} or None")
    return Int8PanelCompressor()


def compressed_words(exact_words: float, *, rows: float,
                     scatter: bool = False) -> float:
    """Cost-model word count for one compressed panel collective: int8
    payload (¼ of the exact fp32 words) plus the fp32 scale sidecar —
    ``rows`` scale words for a gather, 2·``rows`` for a reduce-scatter's
    MAX all-reduce."""
    return exact_words / 4.0 + (2.0 if scatter else 1.0) * rows


# ---------------------------------------------------------------------------
# Generic gradient-compression primitives (per-tensor scales, over nested
# dicts / lists / tuples of tensors).
# ---------------------------------------------------------------------------

def _tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of nested dicts, lists and tuples;
    ``rest`` are trees of the same structure."""
    if isinstance(tree, dict):
        return {key: _tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _is_leaf_tuple(t) -> bool:
    return isinstance(t, tuple) and all(isinstance(x, torch.Tensor)
                                        for x in t)


def _split(out, n: int):
    """A tree whose leaves are n-tuples (as ``_tree_map`` built them) → n
    trees of the same structure."""
    if _is_leaf_tuple(out):
        return out
    if isinstance(out, dict):
        parts = {key: _split(v, n) for key, v in out.items()}
        return tuple({key: parts[key][i] for key in parts} for i in range(n))
    parts = [_split(v, n) for v in out]
    return tuple(type(out)(p[i] for p in parts) for i in range(n))


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8.  Returns (q int8, scale fp32 scalar)."""
    x32 = x.float()
    scale = torch.amax(torch.abs(x32)) / 127.0 + _EPS
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_with_feedback(grads, residuals):
    """Quantise grads + residuals; returns (q_tree, scale_tree,
    new_residuals)."""
    def leaf(g, r):
        tot = g.float() + r
        q, s = quantize_int8(tot)
        return q, s, tot - dequantize_int8(q, s)

    return _split(_tree_map(leaf, grads, residuals), 3)


def compressed_pmean(grads, residuals, group=None):
    """int8 mean over ``group`` with error feedback.

    Wire bytes: 1 byte per element each way (against 2 for bf16, 4 for
    fp32) — here carried as int32 sums, exact — plus a scalar scale per
    tensor, the MAX of the ranks' scales for one shared grid."""
    def leaf(g, r):
        tot = g.float() + r
        scale = _pmax(torch.amax(torch.abs(tot)), group) / 127.0 + _EPS
        q = torch.clamp(torch.round(tot / scale), -127, 127).to(torch.int32)
        summed = q.clone()
        dist.all_reduce(summed, group=group)
        mean_q = summed / dist.get_world_size(group)
        return mean_q.float() * scale, tot - q.float() * scale

    return _split(_tree_map(leaf, grads, residuals), 2)


def topk_with_feedback(grads, residuals, *, frac: float = 0.01):
    """Top-k sparsification with error feedback: keep the largest |g|
    entries (``frac`` of each tensor), zero the rest into the residual."""
    def leaf(g, r):
        tot = (g.float() + r).reshape(-1)
        k = max(int(tot.numel() * frac), 1)
        _, idx = torch.topk(torch.abs(tot), k)
        kept = torch.zeros_like(tot)
        kept[idx] = tot[idx]
        return kept.reshape(g.shape), (tot - kept).reshape(g.shape)

    return _split(_tree_map(leaf, grads, residuals), 2)


def zero_residuals(params):
    """Zero-initialised fp32 error-feedback carry matching ``params``'
    shapes (and devices)."""
    return _tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
