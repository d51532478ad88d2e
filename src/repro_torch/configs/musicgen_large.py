"""musicgen-large — decoder-only over EnCodec tokens [arXiv:2306.05284]

48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048, GELU, bf16.
The audio front end is a stub: inputs are 4 parallel EnCodec codebook
token streams (B, S, 4); their embeddings are summed and the LM head
predicts all 4 codebooks (the delay pattern is the data layer's).  A copy
of ``repro.configs.musicgen_large``.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=2048, tie_embeddings=False, act="gelu",
    period=(LayerSpec(kind="attn"),),
    frontend="audio", n_codebooks=4,
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
)

OPTIMIZER = "adamw"


def reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=64, tie_embeddings=False, act="gelu",
        frontend="audio", n_codebooks=4)
