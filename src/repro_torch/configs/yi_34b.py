"""yi-34b [dense]: 60L, d=7168, 56H GQA kv=8, d_ff=20480, vocab=64000.
Llama-architecture.  [arXiv:2403.04652]"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b", family="dense",
        n_layers=60, d_model=7168, n_heads=56, n_kv=8, d_ff=20480,
        vocab=64000,
        layer_pattern=("attn",), mlp_kind="swiglu", norm_kind="rms",
        pos_kind="rope", rope_theta=5e6,
        param_dtype="bfloat16", dtype="bfloat16",
        optimizer="adafactor", subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=112, n_heads=7, n_kv=1, head_dim=16, d_ff=320,
        vocab=256, param_dtype="float32", dtype="float32", attn_chunk=0,
        remat=False)
