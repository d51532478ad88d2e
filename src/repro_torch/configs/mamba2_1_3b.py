"""mamba2-1.3b — attention-free SSM (SSD, state-space duality)
[hf:state-spaces/mamba2-1.3b; arXiv:2405.21060]

48L d_model=2048, no FFN, vocab=50280, d_state=128, expand 2 (d_inner
4096, 64 heads of 64), conv width 4, SSD chunk 256, tied embedding, bf16,
trained with 8-bit AdamW.  A copy of ``repro.configs.mamba2_1_3b``.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=0,
    vocab=50280, tie_embeddings=True,
    period=(LayerSpec(kind="ssm", has_ffn=False),),
    ssm=SSMConfig(d_state=128, expand=2, headdim=64, n_groups=1,
                  conv_width=4, chunk=256),
    param_dtype="bfloat16", act_dtype="bfloat16", remat=True,
    loss_vocab_chunk=512,
)

OPTIMIZER = "adamw8bit"


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=0, vocab=256,
        tie_embeddings=True,
        period=(LayerSpec(kind="ssm", has_ffn=False),),
        ssm=SSMConfig(d_state=16, expand=2, headdim=16, chunk=16))
