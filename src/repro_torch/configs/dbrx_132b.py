"""dbrx-132b [moe]: 40L, d=6144, 48H GQA kv=8, expert d_ff=10752,
vocab=100352; fine-grained MoE 16 experts top-4.  [hf:databricks/dbrx-base]"""

from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv=8, d_ff=10752,
        vocab=100352,
        layer_pattern=("attn",), mlp_kind="swiglu", norm_kind="layer",
        pos_kind="rope", rope_theta=5e5,
        moe=MoEConfig(n_experts=16, top_k=4, capacity_factor=1.25),
        param_dtype="bfloat16", dtype="bfloat16",
        optimizer="adafactor", subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=96, vocab=256,
        moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=2.0),
        param_dtype="float32", dtype="float32", attn_chunk=0, remat=False)
