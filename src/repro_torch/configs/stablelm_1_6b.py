"""stablelm-1.6b — dense MHA transformer [hf:stabilityai/stablelm-2-1_6b]

24L d_model=2048 32H (kv=32, i.e. MHA) d_ff=5632 vocab=100352, untied
output head, bf16.  A copy of ``repro.configs.stablelm_1_6b``.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab=100352, tie_embeddings=False, rope_theta=10000.0,
    period=(LayerSpec(kind="attn"),),
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    loss_vocab_chunk=512,
)

OPTIMIZER = "adamw"


def reduced() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
        vocab=512, tie_embeddings=False)
