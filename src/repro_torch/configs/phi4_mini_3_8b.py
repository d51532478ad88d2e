"""phi4-mini-3.8b — dense GQA transformer [arXiv:2412.08905]

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064; RoPE SwiGLU, bf16.
A copy of ``repro.configs.phi4_mini_3_8b``.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=200064, tie_embeddings=True, rope_theta=10000.0,
    period=(LayerSpec(kind="attn"),),
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    loss_vocab_chunk=512,
)

OPTIMIZER = "adamw"


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab=512, tie_embeddings=True)
