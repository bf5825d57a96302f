"""Resolve the device an entry point runs on.

The port's entry points default to ``cuda``.  Asking for CUDA on a machine
without a usable card raises: no entry point silently carries on on the
CPU.  The CPU runs only when the caller asks for it (``device="cpu"``), as
the parity tests do.  Under a ``FakeTensorMode`` or ``roofline.counts.stand_in_card`` (the dry
run and ``lower_step``, whose tensors hold no data) ``cuda`` resolves
without a card: to ``meta`` where there is none, which the kernel
wrappers treat as the card (they record the call).
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` means ``cuda``; raise if CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "meta" and _faking():
        return dev
    if dev.type == "cuda" and _faking():
        # fake tensors (the dry run, lower_step) allocate nothing: the card
        # is stood in for, and need not be there.  Without one they live on
        # ``meta`` (indexing a fake CUDA tensor needs a usable CUDA runtime)
        if not torch.cuda.is_available():
            return torch.device("meta")
        return dev if dev.index is not None else torch.device("cuda", 0)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA was asked for (the default device of repro_torch) but "
                "torch.cuda.is_available() is false; pass device='cpu' to run "
                "the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    return dev


def make_generator(device: torch.device, seed: int = 0) -> torch.Generator:
    """A seeded generator living on ``device`` (torch draws on the device
    the generator belongs to)."""
    return torch.Generator(device=device).manual_seed(int(seed))


def _faking() -> bool:
    from repro_torch.roofline.counts import faking
    return faking()
