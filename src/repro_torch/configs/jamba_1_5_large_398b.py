"""jamba-1.5-large-398b — hybrid Mamba + attention 1:7 with MoE 16e top-2
[hf:ai21labs/AI21-Jamba-1.5-Large; arXiv:2403.19887]

72L d_model=8192 64H (GQA kv=8, head_dim 128) d_ff=24576 vocab=65536.  A
period of 8 layers: attention at slot 3, SSM elsewhere; an MoE FFN (16
experts, top-2) on the odd slots, a dense FFN on the even ones.  Untied
output head, bf16, trained with Adafactor.  A copy of
``repro.configs.jamba_1_5_large_398b``.
"""
from repro_torch.configs.base import (LayerSpec, ModelConfig, MoEConfig,
                                      SSMConfig)

_PERIOD = tuple(
    LayerSpec(kind=("attn" if i == 3 else "ssm"), moe=(i % 2 == 1))
    for i in range(8))

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536, tie_embeddings=False, rope_theta=10000.0,
    period=_PERIOD,
    ssm=SSMConfig(d_state=128, expand=2, headdim=64, n_groups=1,
                  conv_width=4, chunk=256),
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576,
                  capacity_factor=1.25),
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    loss_vocab_chunk=512,
)

OPTIMIZER = "adafactor"


def reduced() -> ModelConfig:
    period = tuple(
        LayerSpec(kind=("attn" if i == 3 else "ssm"), moe=(i % 2 == 1))
        for i in range(8))
    return ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, tie_embeddings=False, period=period,
        ssm=SSMConfig(d_state=16, expand=2, headdim=16, chunk=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                      capacity_factor=2.0))
