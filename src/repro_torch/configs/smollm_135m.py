"""smollm-135m [dense]: 30L, d=576, 9H GQA kv=3, d_ff=1536, vocab=49152.
Llama-architecture small model.  [hf:HuggingFaceTB/SmolLM-135M]"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv=3, d_ff=1536, vocab=49152,
        layer_pattern=("attn",), mlp_kind="swiglu", norm_kind="rms",
        pos_kind="rope", tie_embeddings=True,
        param_dtype="bfloat16", dtype="bfloat16",
        optimizer="adamw", subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=72, n_heads=6, n_kv=2, head_dim=12, d_ff=192,
        vocab=256, param_dtype="float32", dtype="float32", attn_chunk=0,
        remat=False)
