"""MPI-FAUN (paper Algorithm 3) on a pr × pc grid of ``torch.distributed``
ranks.  Counterpart of ``repro/core/faun.py``: the reference runs one
program over a device mesh (shard_map), the port runs one process per grid
cell, each holding its own blocks.

Layouts (paper Fig. 2), for p = pr·pc ranks, rank r = i·pc + j at grid
cell (i, j) (``make_faun_mesh``'s ``reshape(pr, pc)`` order):

    A    (m, n)  A_ij      = A[i·m/pr : (i+1)·m/pr, j·n/pc : (j+1)·n/pc]
    W    (m, k)  (W_i)_j   = W rows (i·pc + j)·m/p …    the (pr, pc) order
    Hᵀ   (n, k)  (H^j)^iᵀ  = Hᵀ rows (j·pr + i)·n/p …   the (pc, pr) order

Per iteration, the paper's six collectives on three process groups:

  W-step:
    HHᵀ  = all-reduce_world(gram((H^j)^iᵀ))             [lines 3–4]
    H^jᵀ = all-gather_col((H^j)^iᵀ)       along pr      [line 5]
    V    = A_ij · H^jᵀ                    local         [line 6]
    (AHᵀ)_ij = reduce-scatter_row(V)      along pc      [line 7]
    (W_i)_j  = UpdateW(HHᵀ, ·)            LUC           [line 8]
  H-step: the same with pr ↔ pc                         [lines 9–14]

plus two scalar-sized all-reduces of the error from byproducts, and the
rule's own reductions through ``norm_psum`` (HALS's k column norms of the
W-step; one change norm per accelerated inner sweep).  The grid-row group
holds ranks {i·pc + j'} (group rank j'), the grid-column group {i'·pc + j}
(group rank i'): ``torch.distributed`` orders a group's ranks by global
rank.  A never crosses the wire.

The reference's multi-pod mesh puts a "pod" axis before "pr" and gathers
the panel innermost first (``repro/core/faun.py:177-178``), which lands the
rows in the same order as one gather over pod·pr ranks: ``make_faun_grid``
folds ``pods`` into the grid rows.

``panel_dtype=torch.bfloat16`` ships the two panel gathers in bf16 (half
the bytes), as the bit pattern: the bf16 panel is viewed as bytes, which
every backend gathers (gloo refuses int16, NCCL has no 16-bit integer).
The backend casts the local A block once, when the schedule prepares it.

``panel_compression="int8"`` routes the four panel collectives (the two
Gram all-reduces, the two gathers, the two reduce-scatters) through
``distributed.compression``'s int8 wire with error feedback; each rank
carries its own six residuals (``init_faun_residuals``).  The error's two
all-reduces stay exact.

``lower_step`` runs one iteration on fake tensors of this rank's blocks
and counts it (``roofline/counts.py``, the counterpart of
``repro/roofline/hlo.py``): nothing is allocated and nothing is sent.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.core import rules as _rules

# ---------------------------------------------------------------------------
# The paper's three communication primitives
# ---------------------------------------------------------------------------


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over ``group``, as a new tensor (``x`` is untouched)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def gram_allreduce(X_loc: torch.Tensor, group, *, gram) -> torch.Tensor:
    """k×k Gram of a distributed tall-skinny matrix: the local ``gram(X)``
    (a ``LocalOps.gram``), all-reduced."""
    G = gram(X_loc)
    dist.all_reduce(G, group=group)
    return G


def allgather_panel(X_loc: torch.Tensor, group) -> torch.Tensor:
    """All-gather a factor panel along dim 0 in group-rank order (paper
    lines 5 / 11); every rank's panel has the same shape."""
    X_loc = X_loc.contiguous()
    size = dist.get_world_size(group)
    out = X_loc.new_empty((size * X_loc.shape[0],) + tuple(X_loc.shape[1:]))
    dist.all_gather_into_tensor(out, X_loc, group=group)
    return out


def matmul_reducescatter(Y_loc: torch.Tensor, group) -> torch.Tensor:
    """Reduce-scatter a local product along dim 0 (paper lines 7 / 13):
    group rank g gets rows g·r/size … of the sum."""
    Y_loc = Y_loc.contiguous()
    size = dist.get_world_size(group)
    rows = Y_loc.shape[0]
    if rows % size:
        raise ValueError(f"{rows} rows do not scatter over {size} ranks")
    out = Y_loc.new_empty((rows // size,) + tuple(Y_loc.shape[1:]))
    dist.reduce_scatter_tensor(out, Y_loc, op=dist.ReduceOp.SUM, group=group)
    return out


def allgather_bits(X_loc: torch.Tensor, group, dtype: torch.dtype):
    """All-gather ``X_loc`` rounded to ``dtype``: the rounded panel goes on
    the wire as its bytes and comes back as ``dtype``."""
    low = X_loc.to(dtype).contiguous()
    g = allgather_panel(low.view(torch.uint8), group)
    return g.view(dtype)


# ---------------------------------------------------------------------------
# The grid
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaunGrid:
    """This rank's cell (i, j) of a pr × pc grid and its three process
    groups: ``world`` (every rank of the grid), ``row_group`` (ranks
    {i·pc + j'}: the reduce-scatter along pc and W's gather) and
    ``col_group`` (ranks {i'·pc + j}: H's gather and the reduce-scatter
    along pr)."""

    pr: int
    pc: int
    i: int
    j: int
    world: object
    row_group: object
    col_group: object

    @property
    def p(self) -> int:
        return self.pr * self.pc

    @property
    def w_block(self) -> int:
        """Index of this rank's m/p rows of W (the (pr, pc) order)."""
        return self.i * self.pc + self.j

    @property
    def ht_block(self) -> int:
        """Index of this rank's n/p rows of Hᵀ (the (pc, pr) order)."""
        return self.j * self.pr + self.i


def make_faun_grid(pr: int, pc: int, *, pods: int = 1) -> FaunGrid:
    """The grid over the default process group's first pods·pr·pc ranks:
    rank r sits at (i, j) = divmod(r, pc) with pods·pr grid rows.  Every
    rank of the default group must call this, in the same order (it makes
    the row and column groups with ``new_group``); a rank beyond the grid
    gets ``ValueError`` after the groups exist."""
    if not dist.is_initialized():
        raise RuntimeError("make_faun_grid needs an initialised default "
                           "process group (torch.distributed."
                           "init_process_group, util.dist.spawn or "
                           "util.dist.init_from_env)")
    if min(pr, pc, pods) < 1:
        raise ValueError(f"grid sizes must be >= 1, got pods={pods}, "
                         f"pr={pr}, pc={pc}")
    rows = pods * pr
    p = rows * pc
    world_size = dist.get_world_size()
    if p > world_size:
        raise ValueError(f"a {rows}×{pc} grid needs {p} ranks, the process "
                         f"group has {world_size}")
    world = dist.new_group(list(range(p)))
    row_groups = [dist.new_group([i * pc + j for j in range(pc)])
                  for i in range(rows)]
    col_groups = [dist.new_group([i * pc + j for i in range(rows)])
                  for j in range(pc)]
    rank = dist.get_rank()
    if rank >= p:
        raise ValueError(f"rank {rank} is outside the {rows}×{pc} grid")
    i, j = divmod(rank, pc)
    return FaunGrid(pr=rows, pc=pc, i=i, j=j, world=world,
                    row_group=row_groups[i], col_group=col_groups[j])


# ---------------------------------------------------------------------------
# One iteration, on this rank's blocks
# ---------------------------------------------------------------------------

def faun_iteration(A_blk, W_blk, Ht_blk, normA_sq, state, *, grid: FaunGrid,
                   rule, ops, panel_dtype=None, compress=None):
    """One AU-NMF iteration of Algorithm 3 on this rank's blocks.

    A_blk  : (m/pr, n/pc) this rank's block of A, in ``ops``'s
             representation (cast to ``panel_dtype`` already, if set)
    W_blk  : (m/p, k)     this rank's rows of W
    Ht_blk : (n/p, k)     this rank's rows of Hᵀ
    normA_sq: ‖A‖², all-reduced
    state  : the rule's carry, the same on every rank; under
             ``compress`` the pair ``(rule_state, residuals)``, the
             residuals this rank's own (``init_faun_residuals``), a dict
             updated in place
    compress: a ``distributed.compression`` panel compressor (None = the
             exact collectives)

    Returns (W_blk, Ht_blk, sq_err, state); sq_err is the same on every
    rank.  At 1×1 the collectives copy and the step runs the serial step's
    operations in the serial step's order.
    """
    world, row_g, col_g = grid.world, grid.row_group, grid.col_group
    res = None
    if compress is not None:
        # the residual dict is updated in place: a residual is dropped the
        # moment its successor exists, and the caller's carry holds none
        # of the older ones
        state, res = state

    def norm_psum(v):       # HALS column norms, accelerated change norms
        return all_reduce(v, world)

    # The four panel collectives route through one indirection: exact, or
    # the int8 + error-feedback equivalents (each threading its residual
    # through ``res`` under its key).
    if compress is None:
        def panel_allreduce(x, group, _key):
            dist.all_reduce(x, group=group)
            return x

        if panel_dtype is None:
            def panel_allgather(x, group, _key):
                return allgather_panel(x, group)
        else:
            def panel_allgather(x, group, _key):
                return allgather_bits(x, group, panel_dtype)

        def panel_reduce_scatter(x, group, _key):
            return matmul_reducescatter(x, group)
    else:
        def panel_allreduce(x, group, key):
            y, res[key] = compress.allreduce(x, group, res[key])
            return y

        def panel_allgather(x, group, key):
            y, res[key] = compress.all_gather(x, group, res[key])
            return y

        def panel_reduce_scatter(x, group, key):
            y, res[key] = compress.reduce_scatter(x, group, res[key])
            return y

    # ---- W given H (paper lines 3–8) ----
    HHt = panel_allreduce(ops.gram(Ht_blk), world, "gram_w")     # k×k
    Hj_t = panel_allgather(Ht_blk, col_g, "gather_h")            # (n/pc, k)
    V = ops.mm(A_blk, Hj_t)                                      # (m/pr, k)
    del Hj_t
    AHt_blk = panel_reduce_scatter(V, row_g, "rs_w")             # (m/p, k)
    del V
    W_blk, state = rule.update_w(HHt, AHt_blk, W_blk, state,
                                 norm_psum=norm_psum)
    del AHt_blk             # freed before W's panel is gathered

    # ---- H given W (paper lines 9–14) ----
    WtW = panel_allreduce(ops.gram(W_blk), world, "gram_h")
    Wi = panel_allgather(W_blk, row_g, "gather_w")               # (m/pr, k)
    Yt = ops.mm_t(A_blk, Wi)                                     # (n/pc, k)
    del Wi
    WtA_t_blk = panel_reduce_scatter(Yt, col_g, "rs_h")          # (n/p, k)
    del Yt
    Ht_blk, state = rule.update_h(WtW, WtA_t_blk, Ht_blk, state,
                                  norm_psum=norm_psum)

    # ---- relative error from byproducts (one extra k×k Gram) ----
    HHt_new = gram_allreduce(Ht_blk, world, gram=ops.gram)
    cross = all_reduce((WtA_t_blk.float() * Ht_blk.float()).sum(), world)
    quad = (WtW.float() * HHt_new.float()).sum()
    sq_err = normA_sq - 2.0 * cross + quad
    if compress is not None:
        state = (state, res)
    return W_blk, Ht_blk, sq_err, state


def init_faun_residuals(grid: FaunGrid, m: int, n: int, k: int, *,
                        device=None):
    """Zero error-feedback residuals of this rank's six compressed
    collectives in one iteration, keyed as ``faun_iteration`` reads them:
    the reference's leaves without their leading mesh dimensions, fp32."""
    pr, pc, p = grid.pr, grid.pc, grid.p

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {
        "gram_w": z(k, k),            # HHᵀ all-reduce
        "gather_h": z(n // p, k),     # H panel all-gather
        "rs_w": z(m // pr, k),        # A·Hᵀ reduce-scatter
        "gram_h": z(k, k),            # WᵀW all-reduce
        "gather_w": z(m // p, k),     # W panel all-gather
        "rs_h": z(n // pc, k),        # WᵀA reduce-scatter
    }


# ---------------------------------------------------------------------------
# The fit wrapper
# ---------------------------------------------------------------------------

def fit(A, k: int, *, grid: FaunGrid, algo="bpp", iters: int = 30,
        seed: int | None = None, H0=None, W0=None, backend=None,
        device=None, panel_dtype=None, panel_compression: str | None = None,
        donate: bool = True):
    """Distributed AU-NMF; every rank of ``grid`` calls it with the same
    global A (a tensor, numpy array, sparse tensor or BlockCOO) and gets
    the same global ``NMFResult``.  Thin wrapper over
    ``core.engine.NMFSolver(schedule="faun")``; ``backend=None`` takes
    "sparse" for sparse input and the CUDA kernels ("cuda") otherwise."""
    from repro_torch.backends import infer_backend
    from repro_torch.core.engine import NMFSolver
    if backend is None:
        backend = "sparse" if infer_backend(A) == "sparse" else "cuda"
    solver = NMFSolver(k, algo=_rules.get_rule(algo), schedule="faun",
                       backend=backend, grid=grid, device=device,
                       max_iters=iters, panel_dtype=panel_dtype,
                       panel_compression=panel_compression, donate=donate)
    return solver.fit(A, seed=seed, H0=H0, W0=W0)


def lower_step(grid: FaunGrid, m: int, n: int, k: int, *, algo="bpp",
               dtype=torch.float32, panel_dtype=None,
               panel_compression: str | None = None, backend="dense",
               nnz: int | None = None, device=None):
    """One FAUN iteration on ``grid`` for a global m × n problem, counted
    on fake tensors of this rank's blocks (``NMFSolver.lower_step``): a
    ``roofline.counts.StepRecord``.  ``device=None`` stands in for the
    card, which need not be there."""
    from repro_torch.core.engine import NMFSolver
    from repro_torch.roofline.counts import stand_in_card
    with stand_in_card():
        solver = NMFSolver(k, algo=_rules.get_rule(algo), schedule="faun",
                           backend=backend, grid=grid, device=device,
                           panel_dtype=panel_dtype,
                           panel_compression=panel_compression)
        return solver.lower_step(m, n, dtype=dtype, nnz=nnz)
