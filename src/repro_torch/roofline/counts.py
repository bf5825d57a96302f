"""Per-step accounting of what a rank runs: the counterpart of
``repro/roofline/hlo.py`` (with ``util/wire.py`` for the collectives).

The reference lowers a step to XLA HLO and parses the partitioned module
for dot FLOPs, HBM bytes and collective traffic.  Eager PyTorch has no
such program; instead the step runs once under ``record_step()`` — in the
dry run and ``lower_step`` on fake tensors (``FakeTensorMode``), so
nothing is allocated or sent — and every aten op it dispatches is counted
as it runs:

  * matmul FLOPs by rate class (``roofline.hw``), with
    ``torch.utils.flop_counter``'s formulas, at the dtype of the operands;
  * bytes: the operand and result bytes of every aten op that touches
    memory (views and allocations do not).  This is the eager, unfused
    traffic, which is what the card runs;
  * the port's hand-written kernels by their ``kernels.ops.LAUNCHES``
    names: a kernel wrapper given fake or ``meta`` tensors records one
    ``KernelCall`` with the FLOPs and bytes its bound in PERF.md §6 is
    computed from, and the rate its plan runs at (3xTF32 for the fp32
    products and Grams);
  * the collectives, as the ``util.wire.Collective`` entries
    ``record_wire`` logs, c10d calls and DTensor's functional ones alike;
  * the peak of live bytes allocated inside the record (the storages the
    step's ops create, freed when the last tensor on them goes);
  * ``modelled``: FLOPs that could not run on fake tensors and come from
    the cost model instead (BPP's pivoting solve, ``core/bpp.py``).

A DTensor op is counted as the local ops it runs on this rank, never at
its global size.  Eager PyTorch has no scan: every executed layer is
counted, so there is no trip-count weighting to recover.

``collective_stats``, ``collective_dtype_stats`` and ``weighted_op_costs``
keep the reference's names and fields, read from a record instead of HLO
text; ``StepRecord.as_text()`` (one line an op, kernel call or
collective) stands where the tests grep ``lowered.as_text()``.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import Counter, defaultdict
from dataclasses import dataclass, field

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.roofline.hw import H100, Chip, roofline_times

#: the reference's HLO names of the collectives
_HLO_OP = {"all_reduce": "all-reduce", "all_gather": "all-gather",
           "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
           "broadcast": "broadcast"}
#: the reference's HLO names of the dtypes
_HLO_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.float64: "f64", torch.int8: "s8",
              torch.uint8: "u8", torch.int16: "s16", torch.int32: "s32",
              torch.int64: "s64", torch.bool: "pred"}
#: allocations: they write nothing
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "lift_fresh", "_local_scalar_dense",
               "detach", "alias", "set_", "resize_"}


@dataclass(frozen=True)
class KernelCall:
    """One call of a hand-written kernel, recorded instead of launched."""

    name: str           # its LAUNCHES key
    flops: float        # useful FLOPs
    bytes: float        # each input read once, each output written once
    rate: str           # the rate class its plan runs at (roofline.hw)
    shape: tuple = ()


@dataclass
class StepRecord:
    """What one rank runs in a step (module docstring)."""

    ops: Counter = field(default_factory=Counter)
    flops: dict = field(default_factory=lambda: defaultdict(float))
    dot_count: int = 0
    op_bytes: float = 0.0
    kernels: list = field(default_factory=list)
    collectives: list = field(default_factory=list)
    collective_ranks: list = field(default_factory=list)
    peak_bytes: float = 0.0
    #: bytes of the step's inputs that this rank holds (set by the caller
    #: that made them: ``lower_step``, the dry run)
    arg_bytes: float = 0.0
    #: (name, rate class) -> FLOPs from the cost model
    modelled: dict = field(default_factory=lambda: defaultdict(float))
    lines: list = field(default_factory=list)

    # -- totals --------------------------------------------------------------

    def kernel_calls(self) -> Counter:
        """Calls of each hand-written kernel, by LAUNCHES name."""
        return Counter(c.name for c in self.kernels)

    @property
    def flops_by_rate(self) -> dict:
        """Every FLOP of the step (aten matmuls, kernels, modelled) by rate
        class, as ``roofline_times`` takes them."""
        out: dict = defaultdict(float)
        for kind, f in self.flops.items():
            out[kind] += f
        for c in self.kernels:
            out[c.rate] += c.flops
        for (_, rate), f in self.modelled.items():
            out[rate] += f
        return dict(out)

    @property
    def dot_flops(self) -> float:
        return sum(self.flops_by_rate.values())

    @property
    def bytes(self) -> float:
        """HBM bytes: the aten ops' and the kernels'."""
        return self.op_bytes + sum(c.bytes for c in self.kernels)

    def wire_bytes(self, pod_size: int | None = None) -> tuple[float, float]:
        """(bytes received within a pod, bytes received over collectives
        whose group spans pods of ``pod_size`` ranks); None: one pod."""
        ici = dcn = 0.0
        for c, ranks in zip(self.collectives, self.collective_ranks):
            if pod_size and len({r // pod_size for r in ranks}) > 1:
                dcn += c.received
            else:
                ici += c.received
        return ici, dcn

    def roofline(self, chip: Chip = H100, pod_size: int | None = None
                 ) -> dict:
        ici, dcn = self.wire_bytes(pod_size)
        return roofline_times(self.flops_by_rate, self.bytes, ici, chip=chip,
                              dcn_bytes=dcn)

    def as_text(self) -> str:
        """One line an aten op, kernel call or collective, in issue order."""
        return "\n".join(self.lines)


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------

_ACTIVE: list = []


def active() -> StepRecord | None:
    """The innermost open record, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def is_fake(t) -> bool:
    """Whether ``t`` holds no data: a fake tensor or a ``meta`` one."""
    return isinstance(t, FakeTensor) or (isinstance(t, torch.Tensor)
                                         and t.is_meta)


def record_kernel(name: str, flops: float, nbytes: float, rate: str,
                  shape: tuple = ()) -> None:
    """Record one kernel call on the open record (none open: nothing)."""
    rec = active()
    if rec is None:
        return
    rec.kernels.append(KernelCall(name, float(flops), float(nbytes), rate,
                                  tuple(shape)))
    rec.lines.append(f"kernel {name} {list(shape)} flops={flops:.6g} "
                     f"bytes={nbytes:.6g} rate={rate}")


def record_modelled(name: str, flops: float, rate: str = "float32") -> None:
    """Record FLOPs that come from the cost model (module docstring)."""
    rec = active()
    if rec is None:
        return
    rec.modelled[(name, rate)] += float(flops)
    rec.lines.append(f"modelled {name} flops={flops:.6g} rate={rate}")


def matmul_rate(dtype: torch.dtype) -> str:
    """The rate class an aten matmul of ``dtype`` operands runs at."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bfloat16"
    if dtype == torch.float64:
        return "float64"
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return "float32"


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Recorder(TorchDispatchMode):
    """Counts every aten op dispatched while it is on the mode stack."""

    def __init__(self, rec: StepRecord):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.rec = rec
        self.flop_registry = flop_registry
        self.live = 0
        self.seen: set = set()

    def _free(self, key, nbytes):
        self.seen.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs the op as local ops, which come back here
            return NotImplemented
        packet = func.overloadpacket
        if packet not in self.flop_registry \
                and func is not torch.ops.prim.device.default:
            # a composite op (under inference_mode it arrives whole, as
            # aten::matmul): count the ops it is made of
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        qual = getattr(packet, "_qualified_op_name", str(packet))
        if _PAUSED or qual.startswith("prim::"):
            return out
        name = qual.split("::")[-1]
        rec = self.rec
        rec.ops[qual] += 1
        if qual.startswith("_c10d_functional::"):
            rec.lines.append(f"collective {qual}")
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        flops = 0.0
        if packet in self.flop_registry:
            flops = float(self.flop_registry[packet](*args, **kwargs,
                                                     out_val=out))
            kind = matmul_rate(ins[0].dtype if ins else torch.float32)
            rec.flops[kind] += flops
            rec.dot_count += 1
        traffic = 0
        if outs and not func.is_view and name not in _NO_TRAFFIC:
            traffic = sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in outs)
            rec.op_bytes += traffic
        if not func.is_view:
            self._track(ins, outs)
        if flops or traffic:
            shapes = [list(t.shape) for t in outs]
            rec.lines.append(f"{qual} {shapes} "
                             f"{outs[0].dtype if outs else ''} "
                             f"flops={flops:.6g} bytes={traffic}")
        return out

    def _track(self, ins, outs):
        """Count each new storage an op's outputs live on until it is
        freed; outputs on an input's storage (in-place, out=) are not
        new."""
        inputs = {id(t.untyped_storage()) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in inputs or key in self.seen:
                continue
            nbytes = st.nbytes()
            self.seen.add(key)
            self.live += nbytes
            self.rec.peak_bytes = max(self.rec.peak_bytes, self.live)
            weakref.finalize(st, self._free, key, nbytes)


_PAUSED: list = []


@contextlib.contextmanager
def _global_shapes_uncounted():
    """DTensor infers each op's global output shape by running the op once
    more at the global shapes (its sharding propagation); that run is not
    this rank's work and is not counted."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def quiet(self, op_schema):
        _PAUSED.append(True)
        try:
            return orig(self, op_schema)
        finally:
            _PAUSED.pop()

    ShardingPropagator._propagate_tensor_meta_non_cached = quiet
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


@contextlib.contextmanager
def record_step():
    """Record what runs while the context is open; yields the
    ``StepRecord``.  The torch.distributed calls are recorded and never
    sent (their outputs stay as they were): a step on fake tensors has
    nothing to send, and on a real process group must not wait on the
    other ranks."""
    from repro_torch.util.wire import record_wire
    rec = StepRecord()
    _ACTIVE.append(rec)
    try:
        with record_wire(communicate=False) as log, \
                _global_shapes_uncounted():
            with _Recorder(rec):
                yield rec
            rec.collectives = list(log)
            rec.collective_ranks = list(log.ranks)
            for c in log:
                rec.lines.append(
                    f"collective {_HLO_OP.get(c.op, c.op)} "
                    f"{_HLO_DTYPE.get(c.dtype, str(c.dtype))}"
                    f"{list(c.shape)} group={c.group_size} "
                    f"received={c.received:.6g}")
    finally:
        _ACTIVE.remove(rec)


@contextlib.contextmanager
def fake_mode():
    """A ``FakeTensorMode`` to build and run a step in: the one already
    active, or a new one.  Tensors made inside hold no data, so a step on
    them allocates nothing; ``cuda`` tensors need no card."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    for mode in _get_current_dispatch_mode_stack():
        if isinstance(mode, FakeTensorMode):
            yield mode
            return
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        yield mode


_STAND_IN: list = []


@contextlib.contextmanager
def stand_in_card():
    """While open, ``util.device.resolve_device`` takes ``cuda`` without a
    card (``faking``): for building a solver or model whose tensors are
    then made fake (``lower_step``, the dry run)."""
    _STAND_IN.append(True)
    try:
        yield
    finally:
        _STAND_IN.pop()


def faking() -> bool:
    """Whether a ``FakeTensorMode`` or ``stand_in_card`` is active."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return bool(_STAND_IN) or any(
        isinstance(m, FakeTensorMode)
        for m in _get_current_dispatch_mode_stack())


# ---------------------------------------------------------------------------
# The reference's functions, on a record
# ---------------------------------------------------------------------------

@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=lambda: defaultdict(int))
    bytes_moved: dict = field(default_factory=lambda: defaultdict(float))
    wire_bytes: dict = field(default_factory=lambda: defaultdict(float))

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def table(self) -> str:
        rows = [f"{op:20s} n={self.counts[op]:3d} "
                f"bytes={self.bytes_moved[op]/1e6:10.2f}MB "
                f"wire={self.wire_bytes[op]/1e6:10.2f}MB"
                for op in sorted(self.counts)]
        return "\n".join(rows)


def collective_stats(rec: StepRecord) -> CollectiveStats:
    """Per-op counts, bytes moved (an all-gather's output, a
    reduce-scatter's input, an all-reduce's tensor) and bytes received
    (``util.wire``'s optimal-collective factors), under the reference's
    op names."""
    st = CollectiveStats()
    for c in rec.collectives:
        op = _HLO_OP.get(c.op, c.op)
        n = _prod(c.shape) * c.dtype.itemsize
        if c.op == "all_gather":
            n *= c.group_size
        st.counts[op] += 1
        st.bytes_moved[op] += n
        st.wire_bytes[op] += c.received
    return st


def collective_dtype_stats(rec: StepRecord) -> list[tuple[str, str, tuple]]:
    """(op, dtype, dims) of every collective, the reference's names (an
    all-gather's dims are the rank's own share)."""
    return [(_HLO_OP.get(c.op, c.op), _HLO_DTYPE.get(c.dtype, str(c.dtype)),
             tuple(c.shape)) for c in rec.collectives]


def weighted_op_costs(rec: StepRecord) -> dict:
    """The reference's ``dot_flops``, ``bytes`` and ``dot_count``."""
    return {"dot_flops": rec.dot_flops, "bytes": rec.bytes,
            "dot_count": rec.dot_count + len(rec.kernels)}


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a tree (DTensors: this rank's shard; a
    BlockCOO: its leaves)."""
    import dataclasses
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return tensor_bytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(tensor_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    return 0


def _prod(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n
