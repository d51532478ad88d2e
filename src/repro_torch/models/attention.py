"""GQA self-attention (blocked online-softmax over a sequence, and one-token
decode against a KV cache) and gated cross-attention to front-end
embeddings.

The port of ``repro/models/attention.py``'s single-device path.
``"blocked"`` (the default) and ``"naive"`` are plain tensor code;
``attn_impl="pallas"`` selects the flash-attention kernel
(``kernels.ops.flash_attention``: the hand-written CUDA kernel on the card,
its plain version on the CPU) for every full-sequence pass — prefill,
``backbone``/``lm_loss`` — and for every cross-attention pass, decode's
included (full attention, Sq != Skv), and raises under autograd (the
kernel has no backward pass) and where the reference's kernel asserts
(each length a multiple of ``min(128, length)``: the full-size vision
model's 1600 image tokens are not).  Self-attention decode uses a cache
local to the device under every ``attn_impl``, as the reference does, or,
on a mesh, a cache whose sequence is split over the dp axes
(``decode_self_attention(seq_axes=...)``, the reference's flash-decoding
under ``shard_map``): each rank attends to its rows, only the owner of the
new position writes it, and the partial softmaxes merge by log-sum-exp.

On a mesh whose "tp" axes divide the heads (``attention_tp``),
self-attention and its decode run this rank's ``n_heads / tp`` query heads:
``wq`` column-parallel, ``wo`` row-parallel with *g* after it
(``parallel.collectives``).  Where ``n_kv_heads`` divides over "tp" too,
``wk`` / ``wv`` are column-parallel and a rank's k / v (and its cache) are
its own kv heads; where "tp" is a multiple of ``n_kv_heads``, a rank's
query heads share kv head ``h // (n_heads / n_kv_heads)``, which it
projects from the gathered ``wk`` / ``wv`` (every kv head where a cache
takes them).  Cross-attention splits the same way (``cross_attention(tp=
)``), its K/V cache as the self-attention cache.  Query heads that do not
divide (phi4-mini's 24 at tp = 16) split self-attention as head groups ×
head_dim slices (``attention_heads``, ``self_attention(heads=)``): each
group's ranks hold its query and kv heads on their slices, their partial
scores all-reduced over the group per query block of
``blocked_attention`` (or at once under ``"naive"``); under
``attn_impl="pallas"`` such a block computes whole on every rank, since
the flash kernel finishes each head's softmax inside one launch.  Cross-
attention of such heads computes whole, as the sequence-split decode
does.

Where the kv heads do not divide over "tp" and head_dim does, the cache
splits head_dim at rest (``parallel.ctx.hd_split``), and the decode
computes on that split whether or not the query heads divide
(``decode_self_attention(hd_axes=)``, the reference's ``decode_self_attention(
kv_spec=("dp", None, None, "tp"))``): q, k and v column-parallel and
gathered whole (B·(H + 2·Hkv)·hd elements), RoPE on the whole head_dim
(rotate-half pairs dim i with i + hd / 2, another rank's), each rank's
head_dim slice of k and v written into its cache slice, the scores this
rank's partial sums, all-reduced in float32 over "tp" (B·H·S), the mask
and softmax on every rank, p·v on the slice, its output gathered (B·H·hd)
into ``wo`` row-parallel.  The prefill computes every kv head and keeps
its slice; a cross-attention cache split so is gathered whole, as the
reference's GSPMD gathers it.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import (apply_rope, dense_init, matmul, param,
                                       rms_norm, rope_angles)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx

NEG_INF = -1e30


class Attention(nn.Module):
    """The projections and pre-norm scale of an attention layer; a
    cross-attention layer (``cross``) also has a scalar ``gate`` (its
    output is scaled by tanh(gate)).  The front-end stub gives image
    embeddings at d_model, so wk and wv are (d_model, Hkv·hd) either
    way."""
    def __init__(self, cfg: ModelConfig, device, cross: bool = False):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.hd, cfg.pdtype()
        self.wq = param((d, cfg.n_heads * hd), dt, device)
        self.wk = param((d, cfg.n_kv_heads * hd), dt, device)
        self.wv = param((d, cfg.n_kv_heads * hd), dt, device)
        self.wo = param((cfg.n_heads * hd, d), dt, device)
        self.norm = param((d,), dt, device)
        if cross:
            self.gate = param((), dt, device)


def init_attention(gen: torch.Generator, cfg: ModelConfig, device,
                   cross: bool = False) -> Attention:
    """Projections N(0, 1/d_in), norm one; a cross layer's gate zero, so
    an untrained cross block is the identity (llama-3.2-vision)."""
    p = Attention(cfg, device, cross)
    for w in (p.wq, p.wk, p.wv, p.wo):
        dense_init(gen, w)
    p.norm.fill_(1.0)
    if cross:
        p.gate.zero_()
    return p


def attention_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    p = {"wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
         "wo": ("tp", "fsdp"), "norm": (None,)}
    if cross:
        p["gate"] = ()
    return p


# --------------------------- core attention maths --------------------------

def _repeat_kv(k: torch.Tensor, v: torch.Tensor, heads: int):
    rep = heads // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, block_q: int, block_kv: int,
                      skip_masked: bool = True, scale: float | None = None,
                      reduce=None) -> torch.Tensor:
    """Online-softmax attention in float32, O(S·block) memory.

    q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D), GQA by head repetition; q and
    k start at position 0.  Under ``causal`` and ``skip_masked`` the key
    blocks wholly past a query block's last position are skipped: there
    they would add exp(-1e30 - m) = 0 to every sum and scale it by exp(0) =
    1 (key block 0 makes m finite), so the result and its gradients are
    the same bit for bit as those of every block pair (``skip_masked=
    False``, the reference's loop), with less work (about half of it at
    long sequences) and none of those blocks' scores kept for a backward
    pass.

    ``scale`` (default D^-1/2) multiplies q.  ``reduce``: a function of a
    query block's scores against every key block it reads, (B, H, bq,
    keys) float32, applied before the online softmax (the sum of partial
    scores over head_dim slices: ``self_attention(heads=)``)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    k, v = _repeat_kv(k, v, H)
    scale = D ** -0.5 if scale is None else scale
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
        if reduce is not None:
            last = (min(nkv, ((qi + 1) * bq - 1) // bkv + 1)
                    if skip_masked and causal else nkv)
            scores = reduce(torch.einsum(
                "bqhd,bkhd->bhqk", q_i,
                kb[:, :last].reshape(B, last * bkv, H, D)))
        for kj in range(nkv):
            if skip_masked and causal and kj * bkv > (qi + 1) * bq - 1:
                break
            s = (torch.einsum("bqhd,bkhd->bhqk", q_i, kb[:, kj])
                 if reduce is None else
                 scores[..., kj * bkv:(kj + 1) * bkv])
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


def naive_attention(q, k, v, causal: bool, scale: float | None = None,
                    reduce=None) -> torch.Tensor:
    """``blocked_attention``'s function in one pass; ``scale`` and
    ``reduce`` as there (``reduce`` takes the whole (B, H, Sq, Skv)
    scores)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    k, v = _repeat_kv(k, v, H)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32))
    if reduce is not None:
        s = reduce(s)
    s = s * (D ** -0.5 if scale is None else scale)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Skv, device=q.device)[None, :])
        s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        v.to(torch.float32)).to(q.dtype)


def run_attention(q, k, v, cfg: ModelConfig, causal: bool = True,
                  scale: float | None = None, reduce=None) -> torch.Tensor:
    """``cfg.attn_impl``'s attention; ``scale`` and ``reduce`` as
    ``blocked_attention``'s (not for ``"pallas"``)."""
    if cfg.attn_impl == "naive":
        return naive_attention(q, k, v, causal, scale, reduce)
    if cfg.attn_impl == "pallas":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            raise NotImplementedError(
                "attn_impl='pallas' has no backward pass (the flash kernel "
                "is forward-only, as in the reference): train with "
                "attn_impl='blocked' or 'naive'")
        # the kernel takes (B, H, S, D): transposed views, no copies
        out = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), causal=causal)
        return out.transpose(1, 2)
    if cfg.attn_impl != "blocked":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    return blocked_attention(q, k, v, causal, cfg.attn_block_q,
                             cfg.attn_block_kv, scale=scale, reduce=reduce)


# ------------------------------ layer apply ---------------------------------

def attention_tp(cfg: ModelConfig) -> tuple:
    """The live "tp" axes self-attention splits its heads over on the
    active mesh: the query heads divide over them, and the kv heads do
    too or divide them; none otherwise (every rank computes every head)."""
    tp = ctx.tp_divides(cfg.n_heads)
    n = ctx.get_mesh().size(tp) if tp else 1
    if tp and (cfg.n_kv_heads % n == 0 or n % cfg.n_kv_heads == 0):
        return tp
    return ()


def attention_heads(cfg: ModelConfig) -> ctx.HeadSplit | None:
    """Self-attention as head groups × head_dim slices over "tp"
    (``ctx.head_split``): where the query heads do not divide over it
    (``attention_tp`` is empty) and the split fits; None otherwise, and
    under ``attn_impl="pallas"``, whose flash kernel finishes each head's
    softmax inside one launch and so cannot take a head_dim slice (that
    block computes whole)."""
    if cfg.attn_impl == "pallas" or attention_tp(cfg):
        return None
    return ctx.head_split(cfg.n_heads, cfg.n_kv_heads, cfg.hd)


def _kv_slice(cfg: ModelConfig, tp: tuple) -> slice:
    """The kv heads this rank's query heads attend to in k / v that hold
    every kv head (where "tp" is a multiple of the kv heads: the rank's
    shared one), else all of them."""
    mesh = ctx.get_mesh()
    n = mesh.size(tp) if tp else 1
    if cfg.n_kv_heads % n == 0:
        return slice(None)
    j = mesh.index(tp) * cfg.n_kv_heads // n
    return slice(j, j + 1)


def _kv(params: Attention, src: torch.Tensor, cfg: ModelConfig, tp: tuple,
        all_kv: bool, rows: int, dtype: torch.dtype):
    """(k, v, own) of ``src`` (..., d_model): k / v (rows, -1, kv heads,
    hd) and the slice of their kv heads this rank's query heads attend to.
    Where "tp" divides the kv heads, the rank's own (column-parallel);
    where it is a multiple of them, every kv head when ``all_kv`` (for a
    cache) or on the LUT (whose weight range is the whole weight's), else
    only the rank's shared one, from the gathered ``wk`` / ``wv``."""
    hd = cfg.hd
    shape = lambda t: t.reshape(rows, -1, t.shape[-1] // hd, hd)
    own = _kv_slice(cfg, tp)
    if own == slice(None):
        k, v = (shape(matmul(src, w.to(dtype), cfg, tp))
                for w in (params.wk, params.wv))
        return k, v, own
    # the whole columns; the backward pass sums each rank's part over tp
    mesh = ctx.get_mesh()
    wk, wv = (coll.all_gather(w, mesh, tp, 1) for w in (params.wk,
                                                         params.wv))
    if all_kv or cfg.approx_matmul:
        k, v = (shape(matmul(src, w.to(dtype), cfg)) for w in (wk, wv))
        return k, v, own
    cols = slice(own.start * hd, own.stop * hd)
    k, v = (shape(matmul(src, w[:, cols].to(dtype), cfg)) for w in (wk, wv))
    return k, v, slice(None)


def _qkv(params: Attention, h: torch.Tensor, cfg: ModelConfig, tp: tuple,
         all_kv: bool):
    """(q, k, v, own): q of this rank's query heads (all without ``tp``),
    k / v (B, S, kv heads, hd) and the slice of their kv heads the query
    heads attend to (``_kv``)."""
    B, S, _ = h.shape
    n = ctx.get_mesh().size(tp) if tp else 1
    q = matmul(h, params.wq.to(h.dtype), cfg, tp).reshape(
        B, S, cfg.n_heads // n, cfg.hd)
    return (q,) + _kv(params, h, cfg, tp, all_kv, B, h.dtype)


def self_attention(params: Attention, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor | None = None, tp: tuple = (),
                   all_kv: bool = False, heads: ctx.HeadSplit | None = None):
    """Pre-norm residual GQA self-attention over a full sequence:
    (x + out, (k, v)) with k/v (B, S, Hkv, hd) after RoPE.  ``tp``
    (``attention_tp``): ``params`` hold this rank's columns of wq / wk /
    wv and rows of wo, and k / v its kv heads (``_qkv``; every one with
    ``all_kv``).  ``heads`` (``attention_heads``): ``params`` as at rest,
    this rank computes its group's heads on its head_dim slice, and k / v
    are (B, S, the group's kv heads, the slice) (``_grouped``)."""
    if heads is not None:
        return _grouped(params, x, cfg, positions, heads)
    B, S, _ = x.shape
    hd = cfg.hd
    h = coll.tp_in(rms_norm(x, params.norm, cfg.norm_eps), tp)
    q, k, v, own = _qkv(params, h, cfg, tp, all_kv)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    sin, cos = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    out = run_attention(q, k[:, :, own], v[:, :, own], cfg, causal=True)
    out = matmul(out.reshape(B, S, q.shape[2] * hd),
                 params.wo.to(h.dtype), cfg, tp, row=True)
    return x + out, (k, v)


def _grouped(params: Attention, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor | None, heads: ctx.HeadSplit):
    """``self_attention`` as the reference's GSPMD splits heads that do not
    divide over "tp" (n ranks, ``heads``: g groups × s head_dim slices).
    ``wq`` / ``wk`` / ``wv`` are column-parallel as they lie (a group's
    heads' columns lie on its s ranks); one all-gather over the group
    lays them out as the group's heads × this rank's slice, RoPE rotates
    the slice (its rotate-half pairs are its own), the scores are this
    rank's partial sums over its slice, all-reduced in float32 over the
    group per query block; softmax runs on the whole scores on each of
    the group's ranks, p·v on the slice; the output is gathered over the
    group to whole head_dim, and ``wo`` is row-parallel, *g* after it.
    The scale is the whole head_dim's."""
    B, S, _ = x.shape
    hd, axes = cfg.hd, heads.axes
    h = coll.tp_in(rms_norm(x, params.norm, cfg.norm_eps), axes)
    q, k, v = coll.group_heads([matmul(h, w.to(h.dtype), cfg, axes)
                                for w in (params.wq, params.wk, params.wv)],
                               heads, hd)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    sin, cos = rope_angles(positions, hd, cfg.rope_theta)
    w = hd // (2 * heads.slices)
    freqs = slice(heads.slice * w, (heads.slice + 1) * w)
    q = apply_rope(q, sin[..., freqs], cos[..., freqs])
    k = apply_rope(k, sin[..., freqs], cos[..., freqs])
    out = run_attention(q, k, v, cfg, causal=True, scale=hd ** -0.5,
                        reduce=lambda s: coll.group_sum(s, heads))
    out = coll.group_output(out, heads).reshape(B, S, -1)
    rows = params.wo.shape[0]
    out = matmul(out[..., heads.slice * rows:(heads.slice + 1) * rows],
                 params.wo.to(h.dtype), cfg, axes, row=True)
    return x + out, (k, v)


def cross_attention(params: Attention, x: torch.Tensor,
                    kv_embeds: torch.Tensor | None, cfg: ModelConfig,
                    kv_cache: tuple | None = None, tp: tuple = (),
                    all_kv: bool = False):
    """Pre-norm gated cross-attention to front-end embeddings (no RoPE, not
    causal): (x + tanh(gate)·out, (k, v)).

    x: (B, S, D).  k and v are projected from ``kv_embeds`` (B', N, D)
    through ``matmul`` (the LUT under ``approx_matmul``; the embeddings are
    not normed) and reshaped to (B, B'·N / B, Hkv, hd) with x's B, as the
    reference reshapes them (a microbatch given the whole batch's
    embeddings folds B' / B images into each row's keys), or read from
    ``kv_cache`` = (k, v).  ``tp`` (``attention_tp``): this rank's query
    heads (``wq`` column-parallel, ``wo`` row-parallel with *g*, the gate
    after it) and kv heads as self-attention's (``_kv``; every one with
    ``all_kv``, and so in a cache that holds them all).  The embeddings
    are inputs: no gradient flows to them."""
    B, S, _ = x.shape
    hd = cfg.hd
    h = coll.tp_in(rms_norm(x, params.norm, cfg.norm_eps), tp)
    n = ctx.get_mesh().size(tp) if tp else 1
    q = matmul(h, params.wq.to(h.dtype), cfg, tp).reshape(
        B, S, cfg.n_heads // n, hd)
    if kv_cache is not None:
        k, v = kv_cache
        own = _kv_slice(cfg, tp)
    else:
        k, v, own = _kv(params, kv_embeds, cfg, tp, all_kv, B, h.dtype)
    out = run_attention(q, k[:, :, own], v[:, :, own], cfg, causal=False)
    out = matmul(out.reshape(B, S, q.shape[2] * hd),
                 params.wo.to(h.dtype), cfg, tp, row=True)
    gate = torch.tanh(params.gate.to(torch.float32)).to(out.dtype)
    return x + gate * out, (k, v)


def decode_self_attention(params: Attention, x: torch.Tensor,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          pos: torch.Tensor, cfg: ModelConfig,
                          seq_axes: tuple | None = None, tp: tuple = (),
                          hd_axes: tuple = ()):
    """One-token decode step against a KV cache.

    x: (B, 1, D); caches (B, S_max, Hkv, hd); pos: (B,) current lengths.
    The new token's k/v are written into the caches in place (saving a
    copy of the whole cache per step); returns (x + out, k_cache, v_cache).

    ``seq_axes``: the active mesh's axes over which the caches' sequence is
    split (this rank holds rows ``[i · S_local, (i + 1) · S_local)``, ``i``
    its row-major coordinate over them); x and pos are the same on every
    rank.  The rank that owns a position writes the token there, and the
    ranks' partial softmax statistics merge by log-sum-exp
    (``_partial_decode_attn``; max, then sums of l·w and o·w).  ``()`` is
    the one-shard case: the same arithmetic over the whole cache, no
    collective (the ordinary path rounds q and the softmax weights to the
    cache's dtype, as the reference's does; this one keeps them float32).

    ``tp`` (``attention_tp``, not with ``seq_axes``): this rank's query
    heads; the caches hold its kv heads, or every kv head where "tp" is a
    multiple of them (the rank writes each and attends to its own).

    ``hd_axes`` (``ctx.hd_split``, not with ``seq_axes`` or ``tp``): the
    live "tp" axes the caches split head_dim over, (B, S_max, Hkv, hd /
    n) here; ``params`` hold this rank's columns of wq / wk / wv and rows
    of wo as at rest (``_hd_split_decode``).
    """
    if hd_axes:
        return _hd_split_decode(params, x, k_cache, v_cache, pos, cfg,
                                hd_axes)
    B = x.shape[0]
    hd = cfg.hd
    h = coll.tp_in(rms_norm(x, params.norm, cfg.norm_eps), tp)
    q, k_new, v_new, own = _qkv(params, h, cfg, tp, all_kv=True)
    sin, cos = rope_angles(pos[:, None], hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k_new = apply_rope(k_new, sin, cos)
    rows = torch.arange(B, device=x.device)
    if seq_axes is None:
        k_cache[rows, pos] = k_new[:, 0].to(k_cache.dtype)
        v_cache[rows, pos] = v_new[:, 0].to(v_cache.dtype)
        valid = (torch.arange(k_cache.shape[1], device=x.device)[None, :]
                 <= pos[:, None])                             # (B, S)
        out = _masked_decode_attn(q, k_cache[:, :, own], v_cache[:, :, own],
                                  valid, cfg)
    else:
        out = _seq_split_decode_attn(q, k_new, v_new, k_cache, v_cache, pos,
                                     cfg, seq_axes).to(x.dtype)
    out = matmul(out.reshape(B, 1, q.shape[2] * hd),
                 params.wo.to(h.dtype), cfg, tp, row=True)
    return x + out, k_cache, v_cache


def _hd_split_decode(params: Attention, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, cfg: ModelConfig, axes: tuple):
    """``decode_self_attention`` on caches split on head_dim over the live
    "tp" axes ``axes`` (n ranks; this rank's slice ``own`` of each head).
    Each rank projects its columns of q, k and v and one all-gather makes
    them whole; RoPE pairs dim i with i + hd / 2, so it rotates the whole
    head_dim before the slice is taken.  The rank writes its slice of the
    new k / v, attends with its partial scores summed over ``axes``, and the
    outputs' slices are gathered to feed ``wo``'s rows at rest (the
    reference's GSPMD moves the same B·H·hd elements there)."""
    mesh = ctx.get_mesh()
    B, n, j = x.shape[0], mesh.size(axes), mesh.index(axes)
    width = cfg.hd // n
    own = slice(j * width, (j + 1) * width)
    h = rms_norm(x, params.norm, cfg.norm_eps)
    q, k_new, v_new = coll.gather_columns(
        [matmul(h, w.to(h.dtype), cfg, axes)
         for w in (params.wq, params.wk, params.wv)], axes)
    sin, cos = rope_angles(pos[:, None], cfg.hd, cfg.rope_theta)
    q = apply_rope(q.reshape(B, 1, cfg.n_heads, cfg.hd), sin, cos)
    k_new = apply_rope(k_new.reshape(B, 1, cfg.n_kv_heads, cfg.hd), sin,
                       cos)
    v_new = v_new.reshape(B, 1, cfg.n_kv_heads, cfg.hd)
    rows = torch.arange(B, device=x.device)
    k_cache[rows, pos] = k_new[:, 0, :, own].to(k_cache.dtype)
    v_cache[rows, pos] = v_new[:, 0, :, own].to(v_cache.dtype)
    valid = (torch.arange(k_cache.shape[1], device=x.device)[None, :]
             <= pos[:, None])                                 # (B, S)
    out = _masked_decode_attn(q[..., own], k_cache, v_cache, valid, cfg,
                              tp=axes)
    out = coll.all_gather_raw(out, mesh, axes, 3).reshape(B, 1, -1)
    k_rows = out.shape[-1] // n
    out = matmul(out[..., j * k_rows:(j + 1) * k_rows],
                 params.wo.to(h.dtype), cfg, axes, row=True)
    return x + out, k_cache, v_cache


def _masked_decode_attn(q, k, v, valid, cfg: ModelConfig, tp: tuple = ()
                        ) -> torch.Tensor:
    """q: (B, 1, H, hd); k/v: (B, S, Hkv, hd); valid: (B, S) -> (B, 1, H,
    hd).  Grouped heads without repeating the cache; q is rounded to the
    cache's dtype and both contractions accumulate in float32, as the
    reference's ``preferred_element_type``.  ``tp``: the axes head_dim is
    split over (q, k and v hold this rank's slice): the scores are partial
    sums, all-reduced over them in float32; the scale stays the whole
    head_dim's, and p·v gives this rank's slice of the output."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, 1, Hkv, H // Hkv, hd).to(k.dtype).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(torch.float32))
    if tp:
        s = coll.all_reduce_raw(s, ctx.get_mesh(), tp)
    s = s * (cfg.hd ** -0.5)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)                      # (B, Hkv, g, 1, S)
    out = torch.einsum("bhgqk,bkhd->bqhgd",
                       p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _partial_decode_attn(q, k, v, valid, cfg: ModelConfig):
    """Partial softmax statistics over this rank's cache rows: q (B, 1, H,
    hd), k/v (B, S, Hkv, hd), valid (B, S) -> (m (B, H, 1), l (B, H, 1),
    unnormalized o (B, H, 1, hd)), float32 (the reference's
    ``_partial_decode_attn``; grouped heads, no repeated cache)."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, 1, Hkv, H // Hkv, hd).to(torch.float32)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                     k.to(torch.float32)) * (cfg.hd ** -0.5)
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                  # (B, Hkv, g, 1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(torch.float32))
    return (m.reshape(B, H, 1), l.reshape(B, H, 1),
            o.reshape(B, H, 1, hd))


def _seq_split_decode_attn(q, k_new, v_new, k_cache, v_cache, pos,
                           cfg: ModelConfig, seq_axes: tuple):
    """Attention of one token to a cache whose sequence is split over
    ``seq_axes`` -> (B, 1, H, hd) float32; writes the new k/v in place on
    the rank that owns ``pos``."""
    mesh = ctx.get_mesh()
    B, S_local = k_cache.shape[:2]
    dev = q.device
    lo = mesh.index(seq_axes) * S_local if seq_axes else 0
    local = pos - lo
    own = (local >= 0) & (local < S_local)
    # every row writes, the ones that do not own ``pos`` their old value:
    # no data-dependent shape (the dry run traces it; the card never syncs)
    rows, at = torch.arange(B, device=dev), local.clamp(0, S_local - 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[rows, at] = torch.where(own[:, None, None],
                                      new[:, 0].to(cache.dtype),
                                      cache[rows, at])
    gpos = torch.arange(S_local, device=dev) + lo
    valid = gpos[None, :] <= pos[:, None]
    m, l, o = _partial_decode_attn(q, k_cache, v_cache, valid, cfg)
    if seq_axes:
        m_glob = coll.all_reduce_raw(m, mesh, seq_axes, "max")
        w = torch.exp(m - m_glob)
        l = coll.all_reduce_raw(l * w, mesh, seq_axes)
        o = coll.all_reduce_raw(o * w[..., None], mesh, seq_axes)
    out = o / torch.clamp_min(l, 1e-30)[..., None]            # (B, H, 1, hd)
    return out.transpose(1, 2)
