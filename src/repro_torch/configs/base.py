"""Config system: model configs, input shapes, and the --arch registry.
Counterpart of ``repro/configs/base.py``: the port keeps its own copy.

Every assigned architecture is a ``ModelConfig`` in its own module
(``repro_torch/configs/<id>.py``, exact published dims) plus a ``reduced()``
variant for CPU tests.  ``get_config`` maps --arch ids (hyphenated or
underscored) to configs.  The reference's ``param_dtype_jnp`` /
``dtype_jnp`` are ``param_dtype_torch`` / ``dtype_torch`` here.
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Literal

import torch

BlockKind = Literal["attn", "local_attn", "cross_attn", "mlstm", "slstm",
                    "rglru"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    shared_expert: bool = False     # llama4-style always-on shared FFN
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm
    n_layers: int                     # decoder layers for enc-dec models
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # Block structure. ``layer_pattern`` cycles over the decoder stack;
    # entries are BlockKind. MoE applies to every block with an FFN when
    # moe.n_experts > 0.
    layer_pattern: tuple[str, ...] = ("attn",)
    mlp_kind: str = "swiglu"          # swiglu|geglu|gelu|none
    norm_kind: str = "rms"            # rms|layer
    pos_kind: str = "rope"            # rope|learned|sinusoidal|none
    qkv_bias: bool = False
    attn_out_bias: bool = False
    mlp_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0                   # local_attn window (tokens)
    logit_softcap: float = 0.0
    max_learned_pos: int = 32_768     # learned-position table size

    # Encoder (enc-dec models): encoder self-attn only, decoder cross-attends
    # every layer (whisper style).
    encoder_layers: int = 0
    encoder_pattern: tuple[str, ...] = ("attn",)

    # Modality stubs (precomputed embeddings fed straight to the backbone).
    frontend: str = "none"            # none|audio_frames|image_patches
    num_image_tokens: int = 0

    # Recurrent cells
    conv_width: int = 4               # temporal conv for rglru / mlstm paths
    mlstm_chunk: int = 256
    rglru_c: float = 8.0

    moe: MoEConfig = field(default_factory=MoEConfig)

    # Numerics / memory
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"           # activation dtype
    remat: bool = True                # layer groups recomputed in backward
    remat_policy: str = "full"        # full|dots
    attn_chunk: int = 1024            # blockwise-attention chunk (0 = dense)
    causal_skip: bool = False         # static above-diagonal chunk skipping
    tie_embeddings: bool = False

    # Runtime hints
    optimizer: str = "adamw"          # adamw|adafactor (memory at >=34B)
    subquadratic: bool = False        # eligible for long_500k
    max_seq: int = 524_288

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def param_dtype_torch(self) -> torch.dtype:
        return dtype_of(self.param_dtype)

    @property
    def dtype_torch(self) -> torch.dtype:
        return dtype_of(self.dtype)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train|prefill|decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "whisper_base", "smollm_135m", "granite_20b", "qwen2_72b", "yi_34b",
    "llama32_vision_90b", "xlstm_125m", "llama4_maverick", "dbrx_132b",
    "recurrentgemma_9b",
]

# canonical ids as given in the assignment (hyphenated) -> module names
ALIASES = {
    "whisper-base": "whisper_base",
    "smollm-135m": "smollm_135m",
    "granite-20b": "granite_20b",
    "qwen2-72b": "qwen2_72b",
    "yi-34b": "yi_34b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "xlstm-125m": "xlstm_125m",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "dbrx-132b": "dbrx_132b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}


def _module(arch: str):
    mod_name = ALIASES.get(arch, arch).replace("-", "_")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_reduced_config(arch: str) -> ModelConfig:
    return _module(arch).reduced()


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell, else the skip reason."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 524k dense attention is "
                       "the quadratic cost long_500k exists to exclude")
    return True, ""
