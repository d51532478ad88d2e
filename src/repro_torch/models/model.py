"""Decoder-only LM: parameters, forward, loss, prefill and decode.

The port of ``repro/models/model.py`` for stacks of self-attention,
gated cross-attention and SSM mixers with a dense SwiGLU or GELU MLP, an
MoE FFN or no FFN after each, and a tied or untied output head (per
codebook for the audio front end).  Layer ``i`` is ``cfg.period[i %
len(period)]``, so a hybrid period (jamba: attention at slot 3 of 8, MoE
on the odd slots) is walked as the reference's ``_apply_period`` walks
it.  ``Transformer`` holds the parameters as ``nn.Module``s on an
explicit device and dtype; the apply functions mirror the reference's
names.  Layers are walked with a Python loop (the reference scans over
periods stacked on a leading axis; ``convert.model_params`` unstacks
them).  ``backbone``, ``forward_train`` and ``lm_loss`` carry the MoE
load-balancing aux loss summed over the layers (``ce + 0.01 · aux``, as
the reference).  Cross-attention layers attend to ``image_embeds`` (B,
n_img_tokens, d_model), which ``backbone``, ``forward_train``, ``lm_loss``
and ``prefill`` take as the reference's do.  The audio front end takes
(B, S, n_codebooks) tokens; its logits are (B, S, n_codebooks, vocab) and
its loss the mean CE over every codebook (never chunked).  With
``cfg.remat`` and gradients enabled each layer is
checkpointed (``torch.utils.checkpoint``) as the reference's
``jax.checkpoint`` policies do.  Caches are a list with one entry per
layer: a ``{"k", "v"}`` dict, each (B, max_len, Hkv, hd), for attention,
the same of (B, n_img_tokens, Hkv, hd) for cross-attention (filled by the
prefill from the embeddings, read and left unchanged by decode), an
``ssm.SSMState`` for SSM layers; ``decode_step`` updates the list in
place.  ``prefill`` and ``decode_step`` build no autograd graph.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (MLP, Embed, dense_init, embed_tokens,
                                       init_embed, init_mlp, mlp, param,
                                       rms_norm)


class Layer(nn.Module):
    def __init__(self, mixer: nn.Module, ffn: nn.Module | None):
        super().__init__()
        self.mixer = mixer
        self.ffn = ffn


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, embed: Embed, layers: list[Layer],
                 device):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = param((cfg.d_model,), cfg.pdtype(), device)
        if cfg.frontend == "audio":
            self.lm_head = param((cfg.n_codebooks, cfg.d_model, cfg.vocab),
                                 cfg.pdtype(), device)
        elif not cfg.tie_embeddings:
            self.lm_head = param((cfg.d_model, cfg.vocab), cfg.pdtype(),
                                 device)


def layer_spec(cfg: ModelConfig, i: int) -> LayerSpec:
    """The spec of layer ``i``: its slot in the repeating period."""
    return cfg.period[i % len(cfg.period)]


def _new_layer(cfg: ModelConfig, spec: LayerSpec, device,
               gen: torch.Generator | None) -> Layer:
    """One layer of ``spec``: drawn from ``gen`` (mixer first), or left
    uninitialized when ``gen`` is None."""
    if spec.kind == "ssm":
        mixer = (SSM.init_ssm(gen, cfg, device) if gen is not None
                 else SSM.SSM(cfg, device))
    else:
        cross = spec.cross_attn
        mixer = (A.init_attention(gen, cfg, device, cross) if gen is not None
                 else A.Attention(cfg, device, cross))
    ffn = None
    if spec.has_ffn and spec.moe:
        ffn = (MOE.init_moe(gen, cfg, device) if gen is not None
               else MOE.MoE(cfg, device))
    elif spec.has_ffn:
        ffn = (init_mlp(gen, cfg, device) if gen is not None
               else MLP(cfg, device))
    return Layer(mixer, ffn)


def skeleton(cfg: ModelConfig, device) -> Transformer:
    """An uninitialized ``Transformer`` of ``cfg`` on ``device`` (``meta``
    allocates nothing)."""
    layers = [_new_layer(cfg, layer_spec(cfg, i), device, None)
              for i in range(cfg.n_layers)]
    return Transformer(cfg, Embed(cfg, device), layers, device)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random parameters from ``gen``, on the generator's device, with the
    reference's distributions: projections N(0, 1/d_in), the embedding and
    an untied (or audio) ``lm_head`` N(0, 0.02²), norms one, cross
    layers' gates zero; the MoE and SSM blocks' as ``moe.init_moe`` and
    ``ssm.init_ssm`` say."""
    device = gen.device
    embed = init_embed(gen, cfg, device)
    layers = [_new_layer(cfg, layer_spec(cfg, i), device, gen)
              for i in range(cfg.n_layers)]
    params = Transformer(cfg, embed, layers, device)
    params.final_norm.fill_(1.0)
    if hasattr(params, "lm_head"):
        dense_init(gen, params.lm_head, scale=0.02)
    return params


def _mixer_block(spec: LayerSpec, lp: Layer, x: torch.Tensor,
                 cfg: ModelConfig, image_embeds=None) -> torch.Tensor:
    if spec.kind == "ssm":
        return SSM.ssm_forward(lp.mixer, x, cfg)[0]
    if spec.cross_attn:
        return A.cross_attention(lp.mixer, x, image_embeds, cfg)[0]
    return A.self_attention(lp.mixer, x, cfg)[0]


def _ffn_block(spec: LayerSpec, lp: Layer, x: torch.Tensor,
               cfg: ModelConfig, full_capacity: bool = False):
    """(x after the layer's FFN, its MoE aux loss or 0.0)."""
    if not spec.has_ffn:
        return x, 0.0
    if spec.moe:
        return MOE.moe_ffn(lp.ffn, x, cfg, full_capacity=full_capacity)
    return mlp(lp.ffn, x, cfg), 0.0


def _layer(spec: LayerSpec, lp: Layer, x: torch.Tensor, cfg: ModelConfig,
           image_embeds=None):
    return _ffn_block(spec, lp, _mixer_block(spec, lp, x, cfg, image_embeds),
                      cfg)


def _remat(fn, *args):
    # the model draws no random numbers, so no RNG state is kept
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def backbone(params: Transformer, x: torch.Tensor, cfg: ModelConfig,
             image_embeds=None) -> tuple[torch.Tensor, torch.Tensor | float]:
    """Embedded inputs (and the cross layers' ``image_embeds``) -> (final
    normed hidden states, the MoE aux loss summed over the layers; 0.0
    without MoE layers).

    With ``cfg.remat`` (and gradients enabled) the backward pass recomputes
    each layer from its input: ``remat_policy="all"`` keeps only the
    layer's input, ``"block_outputs"`` also the mixer block's output, so
    the recompute stays within one block (the reference's
    ``save_only_these_names("mixer_out", "ffn_out")``)."""
    remat = cfg.remat and torch.is_grad_enabled()
    if remat and cfg.remat_policy not in ("all", "block_outputs"):
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    aux = 0.0
    for i, lp in enumerate(params.layers):
        spec = layer_spec(cfg, i)
        if not remat:
            x, a = _layer(spec, lp, x, cfg, image_embeds)
        elif cfg.remat_policy == "all":
            x, a = _remat(_layer, spec, lp, x, cfg, image_embeds)
        else:
            x = _remat(_mixer_block, spec, lp, x, cfg, image_embeds)
            x, a = _remat(_ffn_block, spec, lp, x, cfg)
        aux = aux + a
    return rms_norm(x, params.final_norm, cfg.norm_eps), aux


def logits_from_hidden(params: Transformer, x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """The output head: the token embedding transposed when tied, else
    ``lm_head``; audio: (B, S, C, vocab) from the (C, D, vocab) head (a
    plain product under ``approx_matmul`` too, as the reference's
    einsum)."""
    if cfg.frontend == "audio":
        return torch.einsum("bsd,cdv->bscv", x, params.lm_head.to(x.dtype))
    if cfg.tie_embeddings:
        return x @ params.embed.tokens.to(x.dtype).T
    return x @ params.lm_head.to(x.dtype)


def forward_train(params: Transformer, tokens: torch.Tensor,
                  cfg: ModelConfig, image_embeds=None):
    """tokens (B, S) -> (full-sequence logits (B, S, vocab), MoE aux
    loss); audio tokens (B, S, C) -> logits (B, S, C, vocab)."""
    x, aux = backbone(params, embed_tokens(params.embed, tokens, cfg), cfg,
                      image_embeds)
    return logits_from_hidden(params, x, cfg), aux


def _ce_sum(params: Transformer, x: torch.Tensor, targets: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    logits = logits_from_hidden(params, x, cfg).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - tgt).sum()


def lm_loss(params: Transformer, tokens: torch.Tensor,
            targets: torch.Tensor, cfg: ModelConfig,
            image_embeds=None) -> torch.Tensor:
    """Mean next-token cross-entropy (float32; audio: over every position
    and codebook, never chunked) + 0.01 · the MoE aux loss."""
    x, aux = backbone(params, embed_tokens(params.embed, tokens, cfg), cfg,
                      image_embeds)
    if cfg.loss_vocab_chunk and cfg.frontend != "audio":
        ce = _chunked_ce(params, x, targets, cfg)
    else:
        ce = _ce_sum(params, x, targets, cfg) / targets.numel()
    return ce + 0.01 * aux


def _chunked_ce(params: Transformer, x: torch.Tensor, targets: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Cross-entropy over sequence chunks of ``loss_vocab_chunk`` positions,
    so (B, S, vocab) logits never exist at once: under autograd each
    chunk's logits are recomputed in the backward pass rather than kept.
    As the reference, the positions past the last whole chunk are left
    out; a sequence shorter than one chunk is one chunk (the reference's
    reshape fails there)."""
    B, S, _ = x.shape
    C = min(cfg.loss_vocab_chunk, S)
    n = S // C
    ce = (_ce_sum if not torch.is_grad_enabled()
          else lambda *a: _remat(_ce_sum, *a))
    total = sum(ce(params, x[:, i * C:(i + 1) * C],
                   targets[:, i * C:(i + 1) * C], cfg)
                for i in range(n))
    return total / (B * n * C)


# ------------------------------- caches -------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None, device=None) -> list:
    """Zeroed per-layer caches: a ``{"k", "v"}`` dict of (batch, max_len,
    Hkv, hd) for attention layers and of (batch, n_img_tokens, Hkv, hd)
    for cross-attention layers, a zeroed ``SSMState`` (conv tails in
    ``dtype``, the state in float32) for SSM layers."""
    dtype = dtype or cfg.adtype()

    def kv(length):
        shape = (batch, length, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    caches = []
    for i in range(cfg.n_layers):
        spec = layer_spec(cfg, i)
        if spec.kind == "ssm":
            caches.append(SSM.init_ssm_state(cfg, batch, dtype, device))
        else:
            caches.append(kv(cfg.n_img_tokens if spec.cross_attn
                             else max_len))
    return caches


@torch.no_grad()
def prefill(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int | None = None, image_embeds=None):
    """Process a prompt: (last-position logits (B, 1, vocab), caches: KV
    padded to ``max_len``, cross layers' K/V of ``image_embeds``, SSM
    states after the prompt).  The MoE layers run at ``capacity_factor``,
    as the reference's prefill."""
    S = tokens.shape[1]
    pad = (max_len or S) - S
    x = embed_tokens(params.embed, tokens, cfg)
    cache = []
    for i, lp in enumerate(params.layers):
        spec = layer_spec(cfg, i)
        if spec.kind == "ssm":
            x, st = SSM.ssm_forward(lp.mixer, x, cfg, return_state=True)
            cache.append(st)
        elif spec.cross_attn:
            x, (k, v) = A.cross_attention(lp.mixer, x, image_embeds, cfg)
            cache.append({"k": k, "v": v})
        else:
            x, (k, v) = A.self_attention(lp.mixer, x, cfg)
            if pad > 0:
                k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
                v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
            cache.append({"k": k, "v": v})
        x, _ = _ffn_block(spec, lp, x, cfg)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_from_hidden(params, x[:, -1:], cfg), cache


@torch.no_grad()
def decode_step(params: Transformer, cache: list, tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig):
    """One decode step: tokens (B, 1) (audio (B, 1, C)), pos (B,) ->
    (logits (B, 1, vocab) (audio (B, 1, C, vocab)), cache updated in
    place; the cross layers' caches are read, not written).  The MoE
    layers run at full capacity (no drops), as the reference's decode."""
    x = embed_tokens(params.embed, tokens, cfg)
    for i, lp in enumerate(params.layers):
        spec = layer_spec(cfg, i)
        lc = cache[i]
        if spec.kind == "ssm":
            x, cache[i] = SSM.ssm_decode_step(lp.mixer, x, lc, cfg)
        elif spec.cross_attn:
            x, _ = A.cross_attention(lp.mixer, x, None, cfg,
                                     kv_cache=(lc["k"], lc["v"]))
        else:
            x, lc["k"], lc["v"] = A.decode_self_attention(
                lp.mixer, x, lc["k"], lc["v"], pos, cfg)
        x, _ = _ffn_block(spec, lp, x, cfg, full_capacity=True)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_from_hidden(params, x, cfg), cache
