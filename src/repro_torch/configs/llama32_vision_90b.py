"""llama-3.2-vision-90b [vlm]: 100L, d=8192, 64H GQA kv=8, d_ff=28672,
vocab=128256.  80 self-attention + 20 gated cross-attention layers
(pattern: 4×self + 1×xattn), image frontend STUBBED as patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision scaled per assignment]"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, n_heads=64, n_kv=8, d_ff=28672,
        vocab=128256,
        layer_pattern=("attn", "attn", "attn", "attn", "xattn"),
        mlp_kind="swiglu", norm_kind="rms", pos_kind="rope",
        rope_theta=5e5,
        frontend="image_patches", num_image_tokens=1600,
        param_dtype="bfloat16", dtype="bfloat16",
        optimizer="adafactor", subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=5, d_model=96, n_heads=8, n_kv=2, d_ff=256, vocab=256,
        num_image_tokens=16, param_dtype="float32", dtype="float32",
        attn_chunk=0, remat=False)
