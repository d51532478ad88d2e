"""Model configuration of the port: the dense decoder-only path.

The port's copy of the fields of ``repro.configs.base.ModelConfig`` that a
dense GQA transformer with a SwiGLU MLP and a tied or untied output head
reads (serving and training), with ``pdtype()`` / ``adtype()`` returning
torch dtypes, and the reference's TRAIN_4K shape.  ``get_arch`` resolves an
architecture id to its config module; of the reference's ten architectures
the four dense ones are ported (``PORTED``), and the others raise, as do
MoE, SSM, cross-attention and the audio / vision front ends.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating period of a decoder stack."""
    kind: str = "attn"          # "attn" | "ssm"
    moe: bool = False           # FFN is a mixture-of-experts
    cross_attn: bool = False    # cross-attention to frontend embeddings
    has_ffn: bool = True

    @property
    def dense(self) -> bool:
        return (self.kind == "attn" and not self.moe and not self.cross_attn
                and self.has_ffn)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0           # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = True  # False: a separate (d_model, vocab) lm_head
    period: tuple[LayerSpec, ...] = (LayerSpec(),)
    param_dtype: str = "float32"
    act_dtype: str = "float32"
    remat: bool = False         # recompute each layer in the backward pass
    # "all" = save nothing inside a layer; "block_outputs" = save the
    # attention and FFN outputs (recompute within each block only)
    remat_policy: str = "all"
    loss_vocab_chunk: int = 0   # sequence chunk of the CE; 0 = unchunked
    approx_matmul: bool = False  # evolved approximate-multiplier emulation
    # "blocked" (online softmax) | "naive" | "pallas" (the flash kernel,
    # kernels.flash_attention)
    attn_impl: str = "blocked"
    attn_block_q: int = 512
    attn_block_kv: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_periods(self) -> int:
        if self.n_layers % len(self.period):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not "
                             f"divisible by period {len(self.period)}")
        return self.n_layers // len(self.period)

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def adtype(self) -> torch.dtype:
        return getattr(torch, self.act_dtype)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the reference."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                   # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")

ARCH_IDS = (
    "mamba2_1_3b", "phi4_mini_3_8b", "stablelm_1_6b", "stablelm_12b",
    "llama3_2_1b", "qwen3_moe_30b_a3b", "kimi_k2_1t_a32b",
    "jamba_1_5_large_398b", "llama3_2_vision_11b", "musicgen_large",
)
PORTED = ("llama3_2_1b", "phi4_mini_3_8b", "stablelm_1_6b", "stablelm_12b")


def get_arch(arch_id: str):
    """The config module of ``arch_id`` (``CONFIG`` and ``reduced()``)."""
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported yet (ROADMAP A13); "
            f"ported: {PORTED}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")
