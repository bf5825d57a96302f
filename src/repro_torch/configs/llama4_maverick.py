"""llama4-maverick-400b-a17b [moe]: 48L, d=5120, 40H GQA kv=8, expert
d_ff=8192, vocab=202048; MoE 128 experts top-1 + shared expert (Llama-4
style early-fusion backbone; modality fusion not in scope of the assigned
shapes).  [hf:meta-llama/Llama-4 family]"""

from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv=8, d_ff=8192,
        vocab=202048,
        layer_pattern=("attn",), mlp_kind="swiglu", norm_kind="rms",
        pos_kind="rope", rope_theta=5e5,
        moe=MoEConfig(n_experts=128, top_k=1, capacity_factor=1.25,
                      shared_expert=True),
        param_dtype="bfloat16", dtype="bfloat16",
        optimizer="adafactor", subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128, vocab=256,
        moe=MoEConfig(n_experts=8, top_k=1, capacity_factor=2.0,
                      shared_expert=True),
        param_dtype="float32", dtype="float32", attn_chunk=0, remat=False)
