"""kimi-k2-1t-a32b — trillion-parameter MoE [hf:moonshotai/Kimi-K2-Base;
arXiv:2507.20534]

61L d_model=7168 64H (GQA kv=8, head_dim 112) expert d_ff=2048
vocab=163840, 384 experts top-8, untied output head, bf16, trained with
Adafactor.  As in the reference, every layer is MoE (the published model
keeps layer 0 dense and adds a shared expert: under 1% of the
parameters).  A copy of ``repro.configs.kimi_k2_1t_a32b``.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab=163840, tie_embeddings=False, rope_theta=50000.0,
    period=(LayerSpec(kind="attn", moe=True),),
    moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                  capacity_factor=1.25),
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    loss_vocab_chunk=256,
)

OPTIMIZER = "adafactor"


def reduced() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-smoke", family="moe",
        n_layers=2, d_model=56, n_heads=4, n_kv_heads=2, head_dim=14,
        d_ff=32, vocab=512, tie_embeddings=False,
        period=(LayerSpec(kind="attn", moe=True),),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      capacity_factor=2.0))
