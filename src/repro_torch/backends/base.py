"""The ``LocalOps`` interface: local compute as a backend layer.
Counterpart of ``repro/backends/base.py``.

AU-NMF factors into a communication schedule and purely local matrix
products, the only operations that ever touch the data matrix A:

    mm(A, B)    A @ B      — the W-step product  A·Hᵀ   (paper line 6)
    mm_t(A, B)  Aᵀ @ B     — the H-step product  (WᵀA)ᵀ (paper line 12),
                             contracting A's row dim so A is never transposed
    gram(X)     Xᵀ X       — the k×k Gram of a factor panel (lines 3/9)

plus the representation hooks a schedule needs:

    prepare(A, device)     the whole A for one device (the serial schedule)
    blockify(A, gr, gc, block, device, products=)
                           this rank's block (i, j) of A on a gr × gc grid,
                           for the local products that will run on it
    pre_blockify(A)        one conversion before several blockify calls
    cast_block(A, dtype)   the local block for low-precision panels
    norm_sq(A)             ‖A‖_F² in fp32 (of the block it is given)
    global_view_ops()      the variant for global-view (gspmd) programs

and the cost-model hooks ``mm_flops``, ``storage_words`` and
``mm_traffic_words`` (``core/costmodel.py``).

Unlike the reference's, whose ``blockify`` lays out the whole matrix for a
device mesh, the port's grid hooks return only the calling rank's block.
Implementations live next door (dense.py / cuda.py / sparse.py) and are looked up
through a registry so projects can plug their own:

    from repro_torch.backends import LocalOps, register_backend

    class MyOps(LocalOps):
        name = "mine"
        def mm(self, A, B): ...
        def mm_t(self, A, B): ...

    register_backend("mine", MyOps)
    NMFSolver(k, backend="mine")          # or backend=MyOps()
"""

from __future__ import annotations

from typing import Callable, Type, Union

import numpy as np
import torch


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


class LocalOps:
    """Abstract local-compute backend.  Subclass and override the three
    products; the representation hooks default to dense behaviour."""

    #: registry key and the ``NMFSolver(...).backend`` string
    name: str = "abstract"

    #: whether low-precision factor panels (``panel_dtype=``) are supported:
    #: the products must then take low-precision inputs and return fp32
    supports_panel_dtype: bool = True

    #: whether a global-view (gspmd) program may shard this backend's
    #: operands: its products must run as torch operations DTensor can
    #: propagate (a kernel bound through ctypes is opaque to DTensor)
    partitionable: bool = True

    # -- the three local products ------------------------------------------

    def mm(self, A, B):
        """A @ B for A (m, n), B (n, k) -> (m, k)."""
        raise NotImplementedError

    def mm_t(self, A, B):
        """Aᵀ @ B for A (m, n), B (m, k) -> (n, k), without transposing A."""
        raise NotImplementedError

    def gram(self, X):
        """Xᵀ X for a tall-skinny factor panel X (r, k) -> (k, k) fp32."""
        X = _f32(X)
        return X.T @ X

    # -- representation hooks ----------------------------------------------

    def prepare(self, A, device: torch.device) -> torch.Tensor:
        """Canonicalise A for single-device execution: a dense tensor on
        ``device``.  A contiguous tensor already there is used as it is; a
        float64 numpy array becomes float32, as ``jnp.asarray`` makes it in
        the reference."""
        return self._require_dense(A, device)

    def blockify(self, A, gr: int, gc: int, block: tuple[int, int],
                 device: torch.device,
                 products: tuple[str, ...] = ("mm", "mm_t")) -> torch.Tensor:
        """Block ``block`` = (i, j) of A on a gr × gc grid, as a dense
        tensor on ``device``: A[i·m/gr : (i+1)·m/gr, j·n/gc : (j+1)·n/gc].
        A row block of a contiguous A already on ``device`` (and the whole
        of A on a 1 × 1 grid) is a view, never a copy; a column block is
        copied once to make it contiguous.  A global A on the host is
        sliced there, and only the block goes to ``device``.  ``products``
        names the local products that will run on this copy (a subset of
        ("mm", "mm_t"): the naive schedule's row copy runs only ``mm``,
        its column copy only ``mm_t``), so a representation may skip what
        the other needs; a dense block serves both."""
        del products
        if isinstance(A, torch.Tensor) and A.layout != torch.strided:
            return self._require_dense(A, device)      # raises
        m, n = A.shape
        if m % gr or n % gc:
            raise ValueError(f"A of shape {(m, n)} does not tile a "
                             f"{gr}×{gc} grid")
        (i, j), mb, nb = block, m // gr, n // gc
        return self._require_dense(A[i * mb:(i + 1) * mb,
                                     j * nb:(j + 1) * nb], device)

    def abstract_A(self, m: int, n: int, dtype, nnz: int | None, gr: int,
                   gc: int, device) -> torch.Tensor:
        """A stand-in for ``blockify``'s output on a gr × gc grid, holding
        no data (call it under a ``FakeTensorMode``: ``lower_step``)."""
        del nnz
        return torch.empty((m // gr, n // gc), dtype=dtype, device=device)

    def pre_blockify(self, A):
        """One conversion before one or more ``blockify`` calls (the naive
        schedule blockifies twice).  Default: A as it is."""
        return A

    def cast_block(self, A, dtype: torch.dtype):
        """The local block for low-precision panel runs, cast once."""
        return A.to(dtype)

    def norm_sq(self, A) -> torch.Tensor:
        """‖A‖_F² in fp32."""
        from repro_torch.core.error import sq_frobenius
        return sq_frobenius(A)

    def global_view_ops(self) -> "LocalOps":
        """The variant of this backend for global-view (gspmd) programs,
        where DTensor's sharding propagation owns the parallelism.
        Default: self."""
        return self

    # -- cost-model hooks ---------------------------------------------------

    def mm_flops(self, m: float, n: float, k: float,
                 nnz: float = 0.0) -> float:
        """Flops of the two data-matrix products per iteration (A·Hᵀ and
        AᵀW), used by ``costmodel.schedule_cost``."""
        return 4.0 * m * n * k

    def storage_words(self, m: float, n: float, nnz: float = 0.0) -> float:
        """Words needed to store A in this backend's representation."""
        return m * n

    def mm_traffic_words(self, m: float, n: float, k: float,
                         nnz: float = 0.0) -> float:
        """Memory words moved by the two data-matrix products per
        iteration: A streamed once plus the k-width panels read and
        written, per product."""
        return 2.0 * (m * n + n * k + m * k)

    # -- helpers ------------------------------------------------------------

    def _require_dense(self, A, device: torch.device) -> torch.Tensor:
        if isinstance(A, torch.Tensor):
            if A.layout != torch.strided:
                raise ValueError(f"backend {self.name!r} needs a dense data "
                                 f"matrix; got layout {A.layout} — use "
                                 f"backend='sparse' for a sparse tensor")
            return A.to(device).contiguous()
        if isinstance(A, np.ndarray):
            if A.dtype == np.float64:
                A = A.astype(np.float32)
            return torch.from_numpy(np.ascontiguousarray(A)).to(device)
        raise ValueError(
            f"backend {self.name!r} needs a dense (torch or numpy) data "
            f"matrix; got {type(A).__name__} — use backend='sparse' for a "
            f"BlockCOO or a sparse tensor")

    def __repr__(self) -> str:
        return f"{type(self).__name__}(name={self.name!r})"


def infer_backend(A) -> str:
    """Backend name implied by a data matrix's type: "dense" for anything
    dense-array-like (a strided tensor or numpy), "sparse" for a BlockCOO
    or a sparse tensor."""
    if isinstance(A, np.ndarray) or (isinstance(A, torch.Tensor)
                                     and A.layout == torch.strided):
        return "dense"
    return "sparse"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

BackendSpec = Union[str, LocalOps, Type[LocalOps]]

_REGISTRY: dict[str, Callable[[], LocalOps]] = {}


def register_backend(name: str, factory: Callable[[], LocalOps],
                     *, overwrite: bool = False) -> None:
    """Register a ``LocalOps`` factory (a class or zero-arg callable) under
    ``name`` so ``NMFSolver(backend=name)`` finds it."""
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {name!r} is already registered; pass "
                         f"overwrite=True to replace it")
    _REGISTRY[name] = factory


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_backend(spec: BackendSpec) -> LocalOps:
    """Resolve a backend name / instance / class to a ``LocalOps`` instance."""
    if isinstance(spec, LocalOps):
        return spec
    if isinstance(spec, type) and issubclass(spec, LocalOps):
        return spec()
    if isinstance(spec, str):
        try:
            factory = _REGISTRY[spec]
        except KeyError:
            raise ValueError(
                f"unknown backend {spec!r}; choose from "
                f"{available_backends()} or register_backend() your own"
            ) from None
        return factory()
    raise TypeError(f"backend must be a name, LocalOps instance, or LocalOps "
                    f"subclass; got {type(spec).__name__}")
