"""whisper-base [audio]: 6L enc + 6L dec, d=512, 8H MHA, d_ff=2048,
vocab=51865.  Enc-dec with conv frontend STUBBED (input_specs supplies
precomputed frame embeddings).  [arXiv:2212.04356]"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv=8, d_ff=2048, vocab=51865,
        layer_pattern=("attn_cross",),          # decoder: self+cross+FFN
        encoder_layers=6, encoder_pattern=("enc_attn",),
        mlp_kind="gelu", norm_kind="layer", pos_kind="sinusoidal",
        qkv_bias=True, attn_out_bias=True, mlp_bias=True,
        frontend="audio_frames",
        param_dtype="bfloat16", dtype="bfloat16",
        optimizer="adamw", subquadratic=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv=4,
        d_ff=128, vocab=256, param_dtype="float32", dtype="float32",
        attn_chunk=0, remat=False)
