"""qwen3-moe-30b-a3b — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B]

48L d_model=2048 32H (GQA kv=4, head_dim 64) expert d_ff=768
vocab=151936, MoE in every layer, untied output head, bf16, trained with
8-bit AdamW.  A copy of ``repro.configs.qwen3_moe_30b_a3b``.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=64,
    d_ff=768, vocab=151936, tie_embeddings=False, rope_theta=10000.0,
    period=(LayerSpec(kind="attn", moe=True),),
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768,
                  capacity_factor=1.25),
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    remat_policy="block_outputs",
    loss_vocab_chunk=512,
)

OPTIMIZER = "adamw8bit"


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32, vocab=512,
        tie_embeddings=False,
        period=(LayerSpec(kind="attn", moe=True),),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      capacity_factor=2.0))
