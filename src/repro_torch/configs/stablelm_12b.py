"""stablelm-12b — dense GQA transformer [hf:stabilityai/stablelm-2-12b]

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352 (head_dim 160),
untied output head, bf16, trained with 8-bit AdamW.  A copy of
``repro.configs.stablelm_12b``.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=160,
    d_ff=13824, vocab=100352, tie_embeddings=False, rope_theta=10000.0,
    period=(LayerSpec(kind="attn"),),
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    loss_vocab_chunk=512,
)

OPTIMIZER = "adamw8bit"


def reduced() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b-smoke", family="dense",
        n_layers=2, d_model=80, n_heads=4, n_kv_heads=2, head_dim=20,
        d_ff=192, vocab=512, tie_embeddings=False)
