"""qwen2-72b [dense]: 80L, d=8192, 64H GQA kv=8, d_ff=29568, vocab=152064.
QKV bias (Qwen2 signature), RoPE θ=1e6, SwiGLU, RMSNorm.
[arXiv:2407.10671]"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b", family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=29568,
        vocab=152064,
        layer_pattern=("attn",), mlp_kind="swiglu", norm_kind="rms",
        pos_kind="rope", rope_theta=1e6, qkv_bias=True,
        param_dtype="bfloat16", dtype="bfloat16",
        optimizer="adafactor",               # 72B: AdamW fp32 m+v won't fit
        subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=128, n_heads=8, n_kv=2, d_ff=448, vocab=512,
        param_dtype="float32", dtype="float32", attn_chunk=0, remat=False)
