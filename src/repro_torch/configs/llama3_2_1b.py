"""llama3.2-1b — small llama3 dense GQA [hf:meta-llama/Llama-3.2-1B]

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256, bf16.  A copy of
``repro.configs.llama3_2_1b`` without the reference's training-only knobs.
"""
from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=128256, rope_theta=500000.0,
    period=(LayerSpec(kind="attn"),),
    param_dtype="bfloat16", act_dtype="bfloat16",
    loss_vocab_chunk=512,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
        d_ff=256, vocab=512, rope_theta=500000.0)
