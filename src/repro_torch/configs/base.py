"""Model configuration of the port: decoder-only stacks of attention,
cross-attention, SSM, dense-FFN and MoE layers.

The port's copy of the fields of ``repro.configs.base.ModelConfig`` that
these stacks read (serving and training): a repeating ``period`` of
``LayerSpec``s, the ``SSMConfig`` and ``MoEConfig`` blocks, the MLP's
activation, the front-end stub (``"vision"``: ``n_img_tokens`` image
embeddings for the cross-attention layers; ``"audio"``: ``n_codebooks``
parallel token streams), a tied or untied output head, with ``pdtype()`` /
``adtype()`` returning torch dtypes; the reference's four shape cells and
``input_specs``.  ``get_arch`` resolves an architecture id to its config
module; all ten of the reference's architectures are ported (``PORTED``).
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
    act: str = "swiglu"         # dense MLP: "swiglu" | "gelu" (tanh form)
    tie_embeddings: bool = True  # False: a separate (d_model, vocab) lm_head
    period: tuple[LayerSpec, ...] = (LayerSpec(),)
    ssm: SSMConfig = SSMConfig()
    moe: MoEConfig = MoEConfig()
    # front-end stubs: "vision" takes (B, n_img_tokens, d_model) image
    # embeddings for the cross-attention layers; "audio" takes (B, S,
    # n_codebooks) tokens and predicts every codebook
    frontend: str = "none"      # "none" | "vision" | "audio"
    n_img_tokens: int = 0
    n_codebooks: int = 0
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
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)

ARCH_IDS = (
    "mamba2_1_3b", "phi4_mini_3_8b", "stablelm_1_6b", "stablelm_12b",
    "llama3_2_1b", "qwen3_moe_30b_a3b", "kimi_k2_1t_a32b",
    "jamba_1_5_large_398b", "llama3_2_vision_11b", "musicgen_large",
)
PORTED = ARCH_IDS
# pure full-attention architectures skip long_500k (it needs a
# sub-quadratic mixer)
SUBQUADRATIC = ("mamba2_1_3b", "jamba_1_5_large_398b")


def get_arch(arch_id: str):
    """The config module of ``arch_id`` (``CONFIG``, ``reduced()`` and
    ``OPTIMIZER``)."""
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def shapes_for(arch_id: str) -> tuple[ShapeConfig, ...]:
    """The shape cells of ``arch_id``: all four for the sub-quadratic
    architectures, the others without long_500k."""
    if arch_id in SUBQUADRATIC:
        return ALL_SHAPES
    return tuple(s for s in ALL_SHAPES if s is not LONG_500K)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                batch_override: int | None = None
                ) -> dict[str, tuple[tuple[int, ...], torch.dtype]]:
    """Every model input of this cell as a ``(shape, dtype)`` pair, the
    shape and dtype of the reference's ``ShapeDtypeStruct``; allocates
    nothing.  Tokens (and targets, and decode's ``pos``) are int32, with a
    trailing codebook axis for the audio front end; the vision front end
    adds ``image_embeds`` (B, n_img_tokens, d_model) in the activation
    dtype."""
    B = batch_override if batch_override is not None else shape.global_batch
    i32 = torch.int32

    def tokens(bs: int, sl: int):
        if cfg.frontend == "audio":
            return (bs, sl, cfg.n_codebooks), i32
        return (bs, sl), i32

    if shape.mode == "train":
        specs = {"tokens": tokens(B, shape.seq_len),
                 "targets": tokens(B, shape.seq_len)}
    elif shape.mode == "prefill":
        specs = {"tokens": tokens(B, shape.seq_len)}
    else:                       # decode: one new token against a cache of S
        specs = {"tokens": tokens(B, 1), "pos": ((B,), i32)}
    if cfg.frontend == "vision":
        specs["image_embeds"] = ((B, cfg.n_img_tokens, cfg.d_model),
                                 cfg.adtype())
    return specs
