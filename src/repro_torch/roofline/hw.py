"""Target-hardware constants (NVIDIA H100 SXM5 80 GB) for the roofline
analysis.  Counterpart of ``repro/roofline/hw.py``.

The figures are NVIDIA's published ones for the H100 SXM5: dense bf16
and TF32 on the tensor cores, fp32 on the CUDA cores, HBM3, NVLink 4
(18 links of 25 GB/s a direction) inside a node, and one InfiniBand NDR
port (400 Gb/s) per card between nodes, which carries the "pod" axis of
the multi-pod mesh.

The compute term depends on the operand dtype: ``flops`` may be one
number (at the bf16 rate, the reference's convention) or a mapping of
rate class to FLOPs (``StepRecord.flops_by_rate``):

    "bfloat16"  the bf16 tensor-core rate
    "tf32"      the TF32 tensor-core rate
    "tf32x3"    a 3xTF32 product (the fp32 ``gram`` / ``ts_matmul``
                kernels): three TF32 products per useful one
    "float32"   the CUDA cores (the port runs its fp32 ``torch.matmul``
                with TF32 off)
    "float64"   the CUDA cores
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping


@dataclass(frozen=True)
class Chip:
    name: str = "h100-sxm5-80gb"
    peak_bf16_flops: float = 989.4e12    # FLOP/s, dense, tensor cores
    hbm_bytes: float = 80e9              # capacity
    hbm_bw: float = 3.35e12              # B/s, HBM3
    ici_link_bw: float = 25e9            # B/s per NVLink 4 link, a direction
    ici_links: int = 18
    # InfiniBand NDR, one 400 Gb/s port per card: the "pod" axis
    dcn_bw_per_chip: float = 50e9
    peak_tf32_flops: float = 494.7e12    # dense, tensor cores
    peak_fp32_flops: float = 66.9e12     # CUDA cores
    peak_fp64_flops: float = 34e12       # CUDA cores

    @property
    def ici_bw_total(self) -> float:
        return self.ici_link_bw * self.ici_links

    def rate(self, kind: str) -> float:
        """FLOP/s of one rate class (module docstring)."""
        return {"bfloat16": self.peak_bf16_flops,
                "float16": self.peak_bf16_flops,
                "tf32": self.peak_tf32_flops,
                "tf32x3": self.peak_tf32_flops / 3.0,
                "float32": self.peak_fp32_flops,
                "float64": self.peak_fp64_flops}[kind]


H100 = Chip()


def compute_seconds(flops: "float | Mapping[str, float]",
                    chip: Chip = H100) -> float:
    """Seconds of compute for ``flops``: one number at the bf16 rate, or a
    mapping of rate class to FLOPs, each at its rate."""
    if isinstance(flops, Mapping):
        return sum(f / chip.rate(kind) for kind, f in flops.items())
    return flops / chip.peak_bf16_flops


def roofline_times(flops: "float | Mapping[str, float]", hbm_bytes: float,
                   ici_bytes: float, chip: Chip = H100,
                   dcn_bytes: float = 0.0) -> dict:
    """Per-chip three-term roofline (seconds), with the reference's keys.
    Inputs are per-chip values: ``flops`` as ``compute_seconds`` takes
    them, the bytes to and from HBM, and the bytes a rank receives over
    NVLink (``ici_bytes``) and across pods (``dcn_bytes``)."""
    t_compute = compute_seconds(flops, chip)
    t_memory = hbm_bytes / chip.hbm_bw
    t_coll = ici_bytes / chip.ici_bw_total + dcn_bytes / chip.dcn_bw_per_chip
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    terms.update({
        "dominant": dominant,
        "step_lower_bound_s": bound,
        "roofline_fraction_compute": t_compute / bound if bound else 0.0,
    })
    return terms
