"""Building blocks of the dense LM: initializers, RMSNorm, projections,
rotary embeddings, the token embedding and the SwiGLU MLP.

Parameters live in ``nn.Module``s allocated with an explicit device and
dtype and filled from an explicit ``torch.Generator``; they keep the
reference's layouts (projections stored (d_in, d_out), applied as
``x @ w``), so ``convert.model_params`` copies JAX weights across as they
are.  The apply functions mirror ``repro/models/layers.py``.  Serving needs
no gradients, so parameters are created with ``requires_grad=False``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


def param(shape, dtype: torch.dtype, device) -> nn.Parameter:
    """An uninitialized, gradient-free parameter."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def dense_init(gen: torch.Generator, w: torch.Tensor,
               scale: float | None = None) -> None:
    """Fill ``w`` (d_in, d_out) with N(0, 1)·scale drawn in float32,
    scale 1/√d_in by default."""
    scale = scale if scale is not None else 1.0 / math.sqrt(w.shape[0])
    w.copy_(torch.randn(w.shape, generator=gen, device=w.device,
                        dtype=torch.float32) * scale)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.to(torch.float32)).to(dt)


def matmul(x: torch.Tensor, w: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """Projection matmul; through the evolved multiplier's LUT when
    ``cfg.approx_matmul`` (``models/quant.py``)."""
    if cfg.approx_matmul:
        from repro_torch.models import quant
        return quant.approx_matmul(x, w)
    return x @ w


# ----------------------------- rotary embeddings ---------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape positions.shape + (head_dim / 2,)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., S, H, D); sin/cos: (..., S, D/2) broadcast over heads."""
    dt = x.dtype
    x = x.to(torch.float32)
    x1, x2 = x.chunk(2, dim=-1)
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(dt)


# ----------------------------- embeddings ----------------------------------

class Embed(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.tokens = param((cfg.vocab, cfg.d_model), cfg.pdtype(), device)


def init_embed(gen: torch.Generator, cfg: ModelConfig, device) -> Embed:
    e = Embed(cfg, device)
    dense_init(gen, e.tokens, scale=0.02)
    return e


def embed_tokens(params: Embed, tokens: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    return params.tokens[tokens].to(cfg.adtype())


# ----------------------------- MLP (dense FFN) -----------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, cfg.pdtype()
        self.w_gate = param((d, f), dt, device)
        self.w_up = param((d, f), dt, device)
        self.w_down = param((f, d), dt, device)
        self.norm = param((d,), dt, device)


def init_mlp(gen: torch.Generator, cfg: ModelConfig, device) -> MLP:
    p = MLP(cfg, device)
    dense_init(gen, p.w_gate)
    dense_init(gen, p.w_up)
    dense_init(gen, p.w_down)
    p.norm.fill_(1.0)
    return p


def mlp(params: MLP, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Pre-norm residual SwiGLU feed-forward."""
    h = rms_norm(x, params.norm, cfg.norm_eps)
    up = matmul(h, params.w_up.to(h.dtype), cfg)
    gate = matmul(h, params.w_gate.to(h.dtype), cfg)
    inner = F.silu(gate.to(torch.float32)).to(h.dtype) * up
    return x + matmul(inner, params.w_down.to(h.dtype), cfg)
