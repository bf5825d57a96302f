"""Serial AU-NMF (paper Algorithm 1): the iteration body and the factor
initialisers the engine composes, and ``fit``, the serial entry point.
Counterpart of ``repro/core/aunmf.py``.

The data matrix appears only inside the three local products (A·Hᵀ, AᵀW,
and the factor Grams), which ``aunmf_step_rule`` takes as hooks — the
engine fills them from a ``repro_torch.backends.LocalOps`` backend (plain
``torch.matmul`` or the hand-written CUDA kernels).

Unlike the reference, the step carries Hᵀ, a contiguous (n, k) tensor,
instead of H (k, n): the kernels take row-major operands and must never be
handed the strided view ``H.T``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.core.error import sq_error_from_products
from repro_torch.obs.trace import active_tracer


@dataclass
class NMFResult:
    W: Any                # (m, k)
    H: Any                # (k, n)
    rel_errors: Any       # (iters,) relative error after each full iteration
    algo: str = "bpp"
    iters: int = 0
    extras: dict = field(default_factory=dict)

    def save_artifact(self, path: str, **meta) -> str:
        """Persist the trained factors as a serving artifact (factors +
        precomputed Gram + metadata) — see ``repro_torch.serve.artifact``."""
        from repro_torch.serve.artifact import FactorArtifact
        return FactorArtifact.from_result(self, **meta).save(path)


def init_h(generator: torch.Generator, n: int, k: int,
           dtype=torch.float32) -> torch.Tensor:
    """Paper §6.1.3: H (k, n) uniform on [0, 1), drawn on the generator's
    device."""
    return torch.rand((k, n), generator=generator, dtype=dtype,
                      device=generator.device)


def init_w(generator: torch.Generator, m: int, k: int, algo,
           dtype=torch.float32) -> torch.Tensor:
    """W needs no init for additive / re-solving rules (HALS, BPP);
    multiplicative rules (``positive_init``) get a strictly positive seed,
    uniform on [0.1, 1).  ``algo`` is anything ``rules.get_rule``
    resolves."""
    from repro_torch.core import rules
    dev = generator.device
    if rules.get_rule(algo).positive_init:
        W = torch.empty((m, k), dtype=dtype, device=dev)
        return W.uniform_(0.1, 1.0, generator=generator)
    return torch.zeros((m, k), dtype=dtype, device=dev)


def aunmf_step_rule(A, W, Ht, rule, state, normA_sq, *, mm: Callable,
                    mm_t: Callable, gram: Callable, norm_psum=lambda v: v):
    """One full AU-NMF iteration through an ``UpdateRule``; returns
    (W, Ht, sq_error, state).

    ``mm(A, B) -> A @ B``, ``mm_t(A, B) -> Aᵀ @ B`` and ``gram(X) -> XᵀX``
    are the ``LocalOps`` local products (the engine passes its backend's).

    Each phase is a device span of the active tracer
    (``obs.trace.active_tracer()``), under ``obs.phases``' key: no-ops
    while it is disabled.
    """
    span, dev = active_tracer().device_span, Ht.device
    with span("phase.gram_w", dev):
        HHt = gram(Ht)
    with span("phase.mm_w", dev):
        AHt = mm(A, Ht)
    with span("phase.luc_w", dev):
        W, state = rule.update_w(HHt, AHt, W, state, norm_psum=norm_psum)
    with span("phase.gram_h", dev):
        WtW = gram(W)
    with span("phase.mm_h", dev):
        AtW = mm_t(A, W)             # (WᵀA)ᵀ, (n, k)
    with span("phase.luc_h", dev):
        Ht, state = rule.update_h(WtW, AtW, Ht, state, norm_psum=norm_psum)
    with span("phase.error", dev):
        HHt_new = gram(Ht)
        sq = sq_error_from_products(normA_sq, AtW, Ht, WtW, HHt_new)
    return W, Ht, sq, state


def fit(A, k: int, *, algo="bpp", iters: int = 30, seed: int | None = None,
        H0=None, W0=None, backend=None, device=None) -> NMFResult:
    """Run AU-NMF for a fixed number of iterations (the paper's stopping
    criterion for all benchmarks), serially on one device.  Counterpart of
    the reference's ``aunmf.fit`` (``seed=`` for its ``key=``); a thin
    wrapper over ``core.engine.NMFSolver(schedule="serial")``.
    ``backend=None`` takes "sparse" for sparse input and the CUDA kernels
    ("cuda") otherwise, as ``faun.fit`` does."""
    from repro_torch.backends import infer_backend
    from repro_torch.core.engine import NMFSolver
    if backend is None:
        backend = "sparse" if infer_backend(A) == "sparse" else "cuda"
    solver = NMFSolver(k, algo=algo, schedule="serial", backend=backend,
                       device=device, max_iters=iters)
    return solver.fit(A, seed=seed, H0=H0, W0=W0)
