"""recurrentgemma-9b [hybrid]: 38L, d=4096, 16H MQA (kv=1), d_ff=12288
(GeGLU), vocab=256000.  Griffin pattern — 2 RG-LRU recurrent blocks per 1
local-attention block (window 2048).  Sub-quadratic (constant recurrent
state + bounded window cache) -> runs long_500k.  [arXiv:2402.19427]"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv=1, d_ff=12288,
        vocab=256000,
        layer_pattern=("rglru", "rglru", "local_attn"),
        mlp_kind="geglu", norm_kind="rms", pos_kind="rope",
        window=2048, conv_width=4, rglru_c=8.0,
        logit_softcap=30.0,
        param_dtype="bfloat16", dtype="bfloat16",
        optimizer="adamw", subquadratic=True,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=5, d_model=64, n_heads=4, n_kv=1, d_ff=160, vocab=256,
        window=32, param_dtype="float32", dtype="float32", attn_chunk=0,
        remat=False)
