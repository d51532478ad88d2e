"""GQA self-attention: blocked online-softmax over a sequence, and one-token
decode against a KV cache.

The port of ``repro/models/attention.py``'s dense path.  ``"blocked"`` (the
default) and ``"naive"`` are plain tensor code; ``attn_impl="pallas"``
selects the flash-attention kernel (``kernels.ops.flash_attention``: the
hand-written CUDA kernel on the card, its plain version on the CPU) for
every full-sequence pass — prefill, ``backbone``/``lm_loss``.  Decode uses
a cache local to the device under every ``attn_impl``, as the reference
does; the sequence-sharded cache of the reference waits for multi-GPU
support (ROADMAP A11).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (apply_rope, dense_init, matmul, param,
                                       rms_norm, rope_angles)

NEG_INF = -1e30


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.hd, cfg.pdtype()
        self.wq = param((d, cfg.n_heads * hd), dt, device)
        self.wk = param((d, cfg.n_kv_heads * hd), dt, device)
        self.wv = param((d, cfg.n_kv_heads * hd), dt, device)
        self.wo = param((cfg.n_heads * hd, d), dt, device)
        self.norm = param((d,), dt, device)


def init_attention(gen: torch.Generator, cfg: ModelConfig, device
                   ) -> Attention:
    p = Attention(cfg, device)
    for w in (p.wq, p.wk, p.wv, p.wo):
        dense_init(gen, w)
    p.norm.fill_(1.0)
    return p


# --------------------------- core attention maths --------------------------

def _repeat_kv(k: torch.Tensor, v: torch.Tensor, heads: int):
    rep = heads // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, block_q: int, block_kv: int
                      ) -> torch.Tensor:
    """Online-softmax attention in float32, O(S·block) memory.

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D), GQA by head repetition; q and
    k start at position 0."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    k, v = _repeat_kv(k, v, H)
    scale = D ** -0.5
    bq, bkv = min(block_q, Sq), min(block_kv, Skv)
    pq, pkv = (-Sq) % bq, (-Skv) % bkv
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    if pkv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pkv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pkv))
    nq, nkv = q.shape[1] // bq, k.shape[1] // bkv
    dev = q.device
    qb = q.reshape(B, nq, bq, H, D).to(torch.float32) * scale
    kb = k.reshape(B, nkv, bkv, H, D).to(torch.float32)
    vb = v.reshape(B, nkv, bkv, H, D).to(torch.float32)
    q_pos = torch.arange(nq * bq, device=dev).reshape(nq, bq)
    k_pos = torch.arange(nkv * bkv, device=dev).reshape(nkv, bkv)
    kv_valid = k_pos < Skv

    outs = []
    for qi in range(nq):
        q_i = qb[:, qi]
        acc = torch.zeros((B, H, bq, D), dtype=torch.float32, device=dev)
        m = torch.full((B, H, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        for kj in range(nkv):
            s = torch.einsum("bqhd,bkhd->bhqk", q_i, kb[:, kj])
            mask = kv_valid[kj][None, None, None, :]
            if causal:
                mask = mask & (q_pos[qi][None, None, :, None]
                               >= k_pos[kj][None, None, None, :])
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vb[:, kj])
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.transpose(1, 2))                  # (B, bq, H, D)
    out = torch.stack(outs, dim=1).reshape(B, nq * bq, H, D)
    return out[:, :Sq].to(q.dtype)


def naive_attention(q, k, v, causal: bool) -> torch.Tensor:
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    k, v = _repeat_kv(k, v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * (D ** -0.5)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.to(torch.float32)).to(q.dtype)


def run_attention(q, k, v, cfg: ModelConfig, causal: bool = True
                  ) -> torch.Tensor:
    if cfg.attn_impl == "naive":
        return naive_attention(q, k, v, causal)
    if cfg.attn_impl == "pallas":
        # the kernel takes (B, H, S, D): transposed views, no copies
        out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)
    if cfg.attn_impl != "blocked":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return blocked_attention(q, k, v, causal, cfg.attn_block_q,
                             cfg.attn_block_kv)


# ------------------------------ layer apply ---------------------------------

def self_attention(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor | None = None):
    """Pre-norm residual GQA self-attention over a full sequence:
    (x + out, (k, v)) with k/v (B, S, Hkv, hd) after RoPE."""
    B, S, _ = x.shape
    hd = cfg.hd
    h = rms_norm(x, params.norm, cfg.norm_eps)
    q = matmul(h, params.wq.to(h.dtype), cfg).reshape(B, S, cfg.n_heads, hd)
    k = matmul(h, params.wk.to(h.dtype), cfg).reshape(B, S, cfg.n_kv_heads,
                                                      hd)
    v = matmul(h, params.wv.to(h.dtype), cfg).reshape(B, S, cfg.n_kv_heads,
                                                      hd)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    sin, cos = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = run_attention(q, k, v, cfg, causal=True)
    out = matmul(out.reshape(B, S, cfg.n_heads * hd),
                 params.wo.to(h.dtype), cfg)
    return x + out, (k, v)


def decode_self_attention(params: Attention, x: torch.Tensor,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          pos: torch.Tensor, cfg: ModelConfig):
    """One-token decode step against a KV cache.

    x: (B, 1, D); caches (B, S_max, Hkv, hd); pos: (B,) current lengths.
    The new token's k/v are written into the caches in place (saving a
    copy of the whole cache per step); returns (x + out, k_cache, v_cache).
    """
    B = x.shape[0]
    hd = cfg.hd
    h = rms_norm(x, params.norm, cfg.norm_eps)
    q = matmul(h, params.wq.to(h.dtype), cfg).reshape(B, 1, cfg.n_heads, hd)
    k_new = matmul(h, params.wk.to(h.dtype), cfg).reshape(
        B, 1, cfg.n_kv_heads, hd)
    v_new = matmul(h, params.wv.to(h.dtype), cfg).reshape(
        B, 1, cfg.n_kv_heads, hd)
    sin, cos = rope_angles(pos[:, None], hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k_new = apply_rope(k_new, sin, cos)
    rows = torch.arange(B, device=x.device)
    k_cache[rows, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, pos] = v_new[:, 0].to(v_cache.dtype)
    valid = (torch.arange(k_cache.shape[1], device=x.device)[None, :]
             <= pos[:, None])                                 # (B, S)
    out = _masked_decode_attn(q, k_cache, v_cache, valid, cfg)
    out = matmul(out.reshape(B, 1, cfg.n_heads * hd),
                 params.wo.to(h.dtype), cfg)
    return x + out, k_cache, v_cache


def _masked_decode_attn(q, k, v, valid, cfg: ModelConfig) -> torch.Tensor:
    """q: (B, 1, H, hd); k/v: (B, S, Hkv, hd); valid: (B, S) -> (B, 1, H,
    hd).  Grouped heads without repeating the cache; q is rounded to the
    cache's dtype and both contractions accumulate in float32, as the
    reference's ``preferred_element_type``."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, 1, Hkv, H // Hkv, hd).to(k.dtype).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                     k.to(torch.float32)) * (cfg.hd ** -0.5)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)                      # (B, Hkv, g, 1, S)
    out = torch.einsum("bhgqk,bkhd->bqhgd",
                       p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype)
