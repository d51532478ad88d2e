"""Model configuration of the port: decoder-only stacks of attention, SSM,
dense-FFN and MoE layers.

The port's copy of the fields of ``repro.configs.base.ModelConfig`` that
these stacks read (serving and training): a repeating ``period`` of
``LayerSpec``s, the ``SSMConfig`` and ``MoEConfig`` blocks, a tied or
untied output head, with ``pdtype()`` / ``adtype()`` returning torch
dtypes, and the reference's TRAIN_4K shape.  ``get_arch`` resolves an
architecture id to its config module; of the reference's ten architectures
eight are ported (``PORTED``): the four dense ones, the MoE ``qwen3`` and
``kimi``, the SSM ``mamba2`` and the hybrid ``jamba``.  The other two
(``llama3_2_vision_11b``, ``musicgen_large``) raise, as do cross-attention
and the audio / vision front ends (ROADMAP Queue A item 6).
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
    has_ffn: bool = True        # mamba2-only stacks have no FFN


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    headdim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 128            # SSD chunk length
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 768
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


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
    ssm: SSMConfig = SSMConfig()
    moe: MoEConfig = MoEConfig()
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
PORTED = ("llama3_2_1b", "phi4_mini_3_8b", "stablelm_1_6b", "stablelm_12b",
          "qwen3_moe_30b_a3b", "kimi_k2_1t_a32b", "mamba2_1_3b",
          "jamba_1_5_large_398b")


def get_arch(arch_id: str):
    """The config module of ``arch_id`` (``CONFIG`` and ``reduced()``)."""
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}")
    if arch_id not in PORTED:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported yet (ROADMAP Queue A "
            f"item 6: cross-attention and the front ends); "
            f"ported: {PORTED}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")
