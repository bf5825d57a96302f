"""Global-view AU-NMF: the same iteration as ``core/faun.py``, written as a
plain program over global factors with only the data layouts given.
Counterpart of ``repro/core/gspmd.py``.

The reference writes one jit program with input and output shardings and
lets XLA's SPMD partitioner choose the collectives: the control experiment
for the paper's claim that the communication schedule has to be written by
hand.  The port's counterpart of that partitioner is
``torch.distributed.tensor`` (DTensor): on a ``DeviceMesh`` of the grid's
(pr, pc) shape A, W and Hᵀ are DTensors with the paper's layouts, the
iteration calls the backend's products and the rule on them, and DTensor's
sharding propagation inserts the collectives.

Layouts on the (pr, pc) mesh:

    A    (m, n)  (Shard(0), Shard(1))   A_ij = the faun block (i, j)
    W    (m, k)  (Shard(0), Shard(0))   rows in (pr, pc) order, as faun
    Hᵀ   (n, k)  (Shard(0), Shard(0))   rows in (pr, pc) order

DTensor splits a dimension sharded over two mesh dimensions outer to
inner, so Hᵀ's rows lie in (pr, pc) order where faun keeps (pc, pr): the
same blocks, another assignment of them to ranks (the reference's order
would need a strided placement).  The global view hides the difference;
only the collectives DTensor picks depend on it.

Backends:

  * ``dense``   the products are DTensor matmuls; ‖A‖² from each rank's
                block, all-reduced;
  * ``sparse``  A is the whole matrix as one BlockCOO whose flat triplet
                dimension is padded (``pad_global``) and split over all p
                ranks: each rank holds a contiguous share of the triplets
                and its SpMM over them is a partial sum of the global
                product, which enters DTensor as ``Partial`` (the rank's
                result, ``DTensor.from_local``).  The triplets never move;
                the product's other operand is all-gathered (a k-width
                factor);
  * ``cuda``    the hand-written kernels are opaque to DTensor (as a
                ``pallas_call`` is to XLA's partitioner): one rank only,
                on plain tensors, where the iteration is the serial step.

The local update computation is the one place the program leaves the
global view: the LUC kernels are opaque to DTensor, and BPP's masks and
solves have no sharding rule.  Every rule's LUC is row-separable given
the k×k Gram, so on a mesh the rule runs on this rank's rows
(``rule_on_rows``): G made ``Replicate``, R redistributed to the factors'
row layout (DTensor's reduce-scatter of the product), X this rank's
rows, the kernels launched on them.  The rule's own reductions (HALS's
column norms, the accelerated rules' change norms) enter DTensor as
``Partial`` scalars and come back whole: DTensor's all-reduce.  On plain
tensors (one rank, ``cuda``) the rule runs as the serial step's.

``compress`` is a numerics-only emulation, as in the reference: the
quantise → dequantise (with error feedback) runs on the four reduced
products where the hand schedules' collectives sit, keyed ``gram_w``,
``rs_w``, ``gram_h``, ``rs_h``, and the wire stays DTensor's.
"""

from __future__ import annotations

import torch

from repro_torch.core import rules as _rules
from repro_torch.core.engine import _SerialSchedule
from repro_torch.core.error import sq_error_from_products
from repro_torch.util.convert import to_torch


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor for a plain
    tensor)."""
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _replicated_local(x):
    """The whole of a DTensor ``x`` as this rank's plain tensor."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def _row_placements(mesh):
    from torch.distributed.tensor import Shard
    return [Shard(0)] * mesh.ndim


def _psum(v, mesh):
    """A rank's partial sum ``v`` summed over the mesh by DTensor."""
    from torch.distributed.tensor import DTensor, Partial
    return DTensor.from_local(v, mesh, [Partial()] * mesh.ndim,
                              run_check=False).full_tensor()


def rule_on_rows(update, G, R, X, state):
    """``update(G, R, X, state, norm_psum=)`` (a rule's ``update_w`` or
    ``update_h``) on global-view operands.  On DTensors: G whole on every
    rank, R and X split by rows over every mesh dimension (the factors'
    layout), the rule run on this rank's rows with its reductions summed
    over the mesh; the result a DTensor in that layout.  On plain tensors,
    ``update`` as it is."""
    if not is_dtensor(X):
        return update(G, R, X, state)
    from torch.distributed.tensor import DTensor
    mesh = X.device_mesh
    rows = _row_placements(mesh)
    G_loc = _replicated_local(G) if is_dtensor(G) else G
    R_loc = R.redistribute(mesh, rows).to_local()
    X_loc = X.redistribute(mesh, rows).to_local()
    out, state = update(G_loc, R_loc, X_loc, state,
                        norm_psum=lambda v: _psum(v, mesh))
    return DTensor.from_local(out, mesh, rows, run_check=False,
                              shape=X.shape, stride=X.stride()), state


class GlobalViewOps:
    """A backend's products on global-view operands.  A dense A is a
    DTensor and its products are DTensor's; a sparse A is this rank's
    share of the triplets (a plain ``BlockCOO``), whose products take the
    whole of the other operand and return this rank's partial sum as a
    ``Partial`` DTensor."""

    def __init__(self, ops, mesh):
        self.ops, self.mesh = ops, mesh

    def _partial(self, out):
        from torch.distributed.tensor import DTensor, Partial
        return DTensor.from_local(out, self.mesh,
                                  [Partial()] * self.mesh.ndim,
                                  run_check=False)

    def mm(self, A, B):
        if is_dtensor(A):
            return self.ops.mm(A, B)
        return self._partial(self.ops.mm(A, _replicated_local(B)))

    def mm_t(self, A, B):
        if is_dtensor(A):
            return self.ops.mm_t(A, B)
        return self._partial(self.ops.mm_t(A, _replicated_local(B)))

    def gram(self, X):
        return self.ops.gram(X)


def gspmd_iteration(A, W, Ht, normA_sq, state, *, rule, ops, compress=None):
    """Global-view AU-NMF iteration; no explicit collective anywhere.

    ``ops`` supplies the A-products on the global representation (a
    ``GlobalViewOps`` on a mesh, or a backend's ops on plain tensors at one
    rank); the rule runs on this rank's rows (``rule_on_rows``).  Under
    ``compress`` the carry is ``(rule_state, residuals)`` with
    global-shaped residuals laid out like the products.
    The operations run in the serial step's order (``aunmf_step_rule``):
    on plain tensors the iteration is the serial step, bit for bit.
    Returns (W, Ht, sq_err, state).
    """
    rule = _rules.get_rule(rule)
    res = None
    if compress is not None:
        state, res = state          # residuals updated in place (faun's)
    HHt = ops.gram(Ht)
    AHt = ops.mm(A, Ht)
    if compress is not None:
        HHt, res["gram_w"] = compress.simulate_gram(HHt, res["gram_w"])
        AHt, res["rs_w"] = compress.simulate(AHt, res["rs_w"])
    W, state = rule_on_rows(rule.update_w, HHt, AHt, W, state)
    del AHt
    WtW = ops.gram(W)
    AtW = ops.mm_t(A, W)
    if compress is not None:
        WtW, res["gram_h"] = compress.simulate_gram(WtW, res["gram_h"])
        AtW, res["rs_h"] = compress.simulate(AtW, res["rs_h"])
    Ht, state = rule_on_rows(rule.update_h, WtW, AtW, Ht, state)
    sq = sq_error_from_products(normA_sq, AtW, Ht, WtW, ops.gram(Ht))
    if compress is not None:
        state = (state, res)
    return W, Ht, sq, state


def init_gspmd_residuals(m: int, n: int, k: int, *, device=None):
    """Zero error-feedback residuals for the emulated compression of the
    four global products (global-shaped, fp32)."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"gram_w": z(k, k), "rs_w": z(m, k), "gram_h": z(k, k),
            "rs_h": z(n, k)}


# ---------------------------------------------------------------------------
# The engine's schedule
# ---------------------------------------------------------------------------

def grid_mesh(grid, device_type: str):
    """The ``DeviceMesh`` of a ``FaunGrid``'s (pr, pc) shape over the grid's
    own column and row groups (no new process group)."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(grid.p).view(grid.pr, grid.pc)
    return DeviceMesh.from_group([grid.col_group, grid.row_group],
                                 device_type, mesh=ranks,
                                 mesh_dim_names=("pr", "pc"))


class GspmdSchedule(_SerialSchedule):
    """``NMFSolver(schedule="gspmd")``: the global-view iteration on a
    ``FaunGrid``'s mesh (module docstring), behind the engine's schedule
    surface (``prepare_A``, ``place_factors``, ``init_carry``, ``step``,
    ``split_state``, ``collect``)."""

    name = "gspmd"

    def __init__(self, solver, grid):
        from repro_torch.core.engine import _square_grid, _world_size
        from repro_torch.core.faun import FaunGrid, make_faun_grid
        if grid is None:
            grid = make_faun_grid(*_square_grid(_world_size("gspmd")))
        if not isinstance(grid, FaunGrid):
            raise TypeError(f"grid must be a FaunGrid (make_faun_grid), got "
                            f"{type(grid).__name__}")
        self.s, self.grid = solver, grid
        self.grid_shape = (grid.pr, grid.pc)
        self.distributed, self.group = True, grid.world
        # A global-view program leaves the parallelism to DTensor, which
        # cannot split hand-written kernels: the backend swaps in its
        # partitionable variant, and one without any runs on one rank
        # (DTensor would replicate A instead).
        self.gops = solver.ops.global_view_ops()
        if grid.p > 1 and not self.gops.partitionable:
            raise ValueError(
                f"gspmd × {self.gops.name!r} is single-device only: the "
                f"auto-partitioner cannot partition this backend's kernels "
                f"(use schedule='faun', which composes shard_map with them)")
        self.mesh = None
        self.ops = self.gops
        if self.gops.partitionable:
            self.mesh = grid_mesh(grid, _mesh_device_type(solver.device))
            self.ops = GlobalViewOps(self.gops, self.mesh)

    # -- layout ---------------------------------------------------------------

    def _dtensor(self, local, placements, shape):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(local, self.mesh, placements,
                                  run_check=False, shape=shape,
                                  stride=(shape[1], 1))

    def prepare_A(self, A):
        from repro_torch.core.faun import all_reduce
        from torch.distributed.tensor import Shard
        g, ops, dev = self.grid, self.gops, self.s.device
        shape = tuple(A.shape)
        if self.mesh is None:                         # cuda, one rank
            A = ops.prepare(A, dev)
            return A, shape, A.dtype, ops.norm_sq(A)
        if hasattr(ops, "pad_global"):                # sparse: nnz-sharded
            A = ops.prepare(A, dev)
            normA_sq = ops.norm_sq(A)
            A = ops.pad_global(A, g.p)
            return _triplet_share(A, g.w_block, g.p), shape, A.dtype, normA_sq
        m, n = shape
        if m % g.pr or n % g.pc:
            raise ValueError(f"A of shape {shape} does not tile the "
                             f"{g.pr}×{g.pc} mesh")
        blk = ops.blockify(A, g.pr, g.pc, (g.i, g.j), dev)
        normA_sq = all_reduce(ops.norm_sq(blk), g.world)
        return (self._dtensor(blk, [Shard(0), Shard(1)], shape), shape,
                blk.dtype, normA_sq)

    def _rows(self, X):
        """X (global) as this rank's (pr, pc)-order rows, or X itself."""
        if self.mesh is None:
            return X.contiguous()
        from repro_torch.core.engine import _rows
        g = self.grid
        if X.shape[0] % g.p:
            raise ValueError(f"{X.shape[0]} rows do not split over the "
                             f"{g.p} ranks of the mesh")
        return self._dtensor(_rows(X, g.w_block, g.p),
                             _row_placements(self.mesh), tuple(X.shape))

    def place_factors(self, W0, H0):
        return self._rows(W0), self._rows(H0.T)

    def abstract_args(self, m, n, dtype, nnz):
        if self.mesh is None:                         # cuda, one rank
            return super().abstract_args(m, n, dtype, nnz)
        from torch.distributed.tensor import Shard
        g, ops, dev, k = self.grid, self.gops, self.s.device, self.s.k

        def rows(r):
            if r % g.p:
                raise ValueError(f"{r} rows do not split over the {g.p} "
                                 f"ranks of the mesh")
            return self._dtensor(torch.empty((r // g.p, k), dtype=dtype,
                                             device=dev),
                                 _row_placements(self.mesh), (r, k))

        if hasattr(ops, "pad_global"):                # sparse: nnz-sharded
            A = ops.abstract_global_A(m, n, dtype, nnz, g.p, dev)
        else:
            if m % g.pr or n % g.pc:
                raise ValueError(f"A of shape {(m, n)} does not tile the "
                                 f"{g.pr}×{g.pc} mesh")
            A = self._dtensor(ops.abstract_A(m, n, dtype, nnz, g.pr, g.pc,
                                             dev), [Shard(0), Shard(1)],
                              (m, n))
        return (A, rows(m), rows(n),
                torch.empty((), dtype=torch.float32, device=dev))

    def init_residuals(self, m, n):
        return self.place_residuals(
            init_gspmd_residuals(m, n, self.s.k, device=self.s.device))

    def place_residuals(self, res):
        """Global-shaped residuals (arrays or tensors) in the carry's form:
        fp32 on the solver's device; on the mesh the Grams' replicated, the
        panels' row-sharded as the factors."""
        res = {key: to_torch(v, device=self.s.device, dtype=torch.float32)
               for key, v in res.items()}
        if self.mesh is None:
            return res
        from torch.distributed.tensor import Replicate
        rep = [Replicate()] * self.mesh.ndim
        return {key: (self._dtensor(v, rep, tuple(v.shape))
                      if key.startswith("gram") else self._rows(v))
                for key, v in res.items()}

    def split_state(self, state):
        """(rule_state, residuals or None); DTensor residuals come back
        whole (global-shaped, as the reference's)."""
        if self.s.compress is None:
            return state, None
        rule_state, res = state
        return rule_state, {key: _whole(v) for key, v in res.items()}

    # -- the iteration --------------------------------------------------------

    def step(self, A, W, Ht, normA_sq, state):
        W, Ht, sq, state = gspmd_iteration(A, W, Ht, normA_sq, state,
                                           rule=self.s.rule, ops=self.ops,
                                           compress=self.s.compress)
        return W, Ht, _whole(sq), state

    def collect(self, W, Ht):
        return _whole(W), _whole(Ht).T.contiguous()


def _mesh_device_type(device) -> str:
    """The mesh's device type: the device's own, ``cuda`` for the ``meta``
    device that stands for the card in a count (``lower_step``)."""
    return "cuda" if device.type == "meta" else device.type


def _whole(x):
    """A DTensor's global value as a plain tensor (a plain tensor as it
    is)."""
    return x.full_tensor() if is_dtensor(x) else x


def _triplet_share(A, r: int, p: int):
    """Rank ``r``'s contiguous share of a padded 1 × 1 BlockCOO's flat
    triplet dimension: a BlockCOO of the global shape holding those
    triplets (copied, so the padded whole can be freed; at p = 1, A)."""
    import dataclasses
    if p == 1:
        return A
    L = A.vals.shape[-1] // p

    def share(t):
        return t[..., r * L:(r + 1) * L].clone()

    return dataclasses.replace(A, vals=share(A.vals), rows=share(A.rows),
                               cols=share(A.cols), row_major=False)


def fit(A, k: int, *, grid, algo="bpp", iters: int = 30,
        seed: int | None = None, H0=None, W0=None, backend=None,
        device=None, panel_compression: str | None = None):
    """Run the global-view variant end to end (DTensor picks the
    collectives).  Thin wrapper over ``NMFSolver(schedule="gspmd")``;
    ``backend=None`` takes "sparse" for sparse input and "dense" (the
    partitionable one) otherwise."""
    from repro_torch.backends import infer_backend
    from repro_torch.core.engine import NMFSolver
    if backend is None:
        backend = infer_backend(A)
    solver = NMFSolver(k, algo=_rules.get_rule(algo), schedule="gspmd",
                       grid=grid, backend=backend, device=device,
                       max_iters=iters, panel_compression=panel_compression)
    return solver.fit(A, seed=seed, H0=H0, W0=W0)


def lower_step(grid, m: int, n: int, k: int, *, algo="mu",
               dtype=torch.float32, backend="dense", nnz: int | None = None,
               device=None):
    """One global-view iteration on ``grid``'s mesh for a global m × n
    problem, counted on fake tensors of this rank's blocks
    (``NMFSolver.lower_step``); DTensor's collectives are recorded as the
    local ops and functional collectives it runs on this rank."""
    from repro_torch.core.engine import NMFSolver
    from repro_torch.roofline.counts import stand_in_card
    with stand_in_card():
        solver = NMFSolver(k, algo=_rules.get_rule(algo), schedule="gspmd",
                           grid=grid, backend=backend, device=device)
        return solver.lower_step(m, n, dtype=dtype, nnz=nnz)
