"""llama-3.2-vision-11b — cross-attention image layers [hf:meta-llama/Llama-3.2-11B-Vision]

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, bf16.
Period of 5: one gated cross-attention layer + four self-attention
layers (8 cross layers total).  The vision tower is a stub:
``input_specs`` provides precomputed patch embeddings (B, 1600, d_model)
consumed by the cross-attention K/V.  A copy of
``repro.configs.llama3_2_vision_11b``.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

_PERIOD = (LayerSpec(kind="attn", cross_attn=True),) + \
    tuple(LayerSpec(kind="attn") for _ in range(4))

CONFIG = ModelConfig(
    name="llama3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=128256, tie_embeddings=False, rope_theta=500000.0,
    period=_PERIOD, frontend="vision", n_img_tokens=1600,
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    loss_vocab_chunk=512,
)

OPTIMIZER = "adamw8bit"


def reduced() -> ModelConfig:
    period = (LayerSpec(kind="attn", cross_attn=True),
              LayerSpec(kind="attn"))
    return ModelConfig(
        name="llama3.2-vision-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, tie_embeddings=False, period=period,
        frontend="vision", n_img_tokens=16)
