"""granite-20b [dense]: 52L, d=6144, 48H MQA (kv=1), d_ff=24576 (4d),
vocab=49152.  GPT-BigCode-style code model: learned positions, GELU MLP,
attention biases.  [arXiv:2405.04324]"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense",
        n_layers=52, d_model=6144, n_heads=48, n_kv=1, d_ff=24576,
        vocab=49152,
        layer_pattern=("attn",), mlp_kind="gelu", norm_kind="layer",
        pos_kind="learned", max_learned_pos=32768,
        qkv_bias=True, attn_out_bias=True, mlp_bias=True,
        param_dtype="bfloat16", dtype="bfloat16",
        optimizer="adamw", subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=3, d_model=96, n_heads=8, n_kv=1, d_ff=384, vocab=256,
        max_learned_pos=512, param_dtype="float32", dtype="float32",
        attn_chunk=0, remat=False)
