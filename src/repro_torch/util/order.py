"""``lax.top_k``'s order in PyTorch: scores descending, equal scores by
position.  ``torch.topk`` promises no order among ties; a stable sort
does, so ties resolve to the lower index, as in the reference."""

from __future__ import annotations

import torch


def top_k(vals: torch.Tensor, k: int):
    """(values, positions) of the k largest along the last dim, in
    ``lax.top_k``'s order."""
    v, pos = torch.sort(vals, dim=-1, descending=True, stable=True)
    return v[..., :k], pos[..., :k]
