"""xlstm-125m [ssm]: 12L, d=768, 4H, vocab=50304, d_ff=0 (block-internal
projections).  9 mLSTM + 3 sLSTM blocks (pattern m,m,m,s ~ xLSTM[7:1]
spirit at this depth).  Sub-quadratic: constant-size matrix/scalar memory
states -> runs long_500k.  [arXiv:2405.04517]"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m", family="ssm",
        n_layers=12, d_model=768, n_heads=4, n_kv=4, d_ff=0, vocab=50304,
        layer_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        mlp_kind="none", norm_kind="layer", pos_kind="none",
        conv_width=4, mlstm_chunk=256,
        param_dtype="bfloat16", dtype="bfloat16",
        optimizer="adamw", subquadratic=True,
    )


def reduced() -> ModelConfig:
    return config().replace(
        n_layers=4, d_model=64, n_heads=2, n_kv=2, vocab=256,
        mlstm_chunk=16, param_dtype="float32", dtype="float32", remat=False)
