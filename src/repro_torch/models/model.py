"""Decoder-only LM: parameters, forward, loss, prefill and decode.

The port of ``repro/models/model.py`` for stacks of attention and SSM
mixers with a dense SwiGLU MLP, an MoE FFN or no FFN after each, and a
tied or untied output head.  Layer ``i`` is ``cfg.period[i %
len(period)]``, so a hybrid period (jamba: attention at slot 3 of 8, MoE
on the odd slots) is walked as the reference's ``_apply_period`` walks
it.  ``Transformer`` holds the parameters as ``nn.Module``s on an
explicit device and dtype; the apply functions mirror the reference's
names.  Layers are walked with a Python loop (the reference scans over
periods stacked on a leading axis; ``convert.model_params`` unstacks
them).  ``backbone``, ``forward_train`` and ``lm_loss`` carry the MoE
load-balancing aux loss summed over the layers (``ce + 0.01 · aux``, as
the reference).  With ``cfg.remat`` and gradients enabled each layer is
checkpointed (``torch.utils.checkpoint``) as the reference's
``jax.checkpoint`` policies do.  Caches are a list with one entry per
layer: a ``{"k", "v"}`` dict, each (B, max_len, Hkv, hd), for attention,
an ``ssm.SSMState`` for SSM layers; ``decode_step`` updates the list in
place.  ``prefill`` and ``decode_step`` build no autograd graph.
Cross-attention and the audio / vision front ends are not ported (ROADMAP
Queue A item 6) and raise.
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
        if not cfg.tie_embeddings:
            self.lm_head = param((cfg.d_model, cfg.vocab), cfg.pdtype(),
                                 device)


def _check_ported(cfg: ModelConfig) -> None:
    bad = [s for s in cfg.period
           if s.cross_attn or s.kind not in ("attn", "ssm")]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention is not ported (ROADMAP Queue A "
            f"item 6), got {bad}")


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
        mixer = (A.init_attention(gen, cfg, device) if gen is not None
                 else A.Attention(cfg, device))
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
    _check_ported(cfg)
    layers = [_new_layer(cfg, layer_spec(cfg, i), device, None)
              for i in range(cfg.n_layers)]
    return Transformer(cfg, Embed(cfg, device), layers, device)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random parameters from ``gen``, on the generator's device, with the
    reference's distributions: projections N(0, 1/d_in), the embedding and
    an untied ``lm_head`` N(0, 0.02²), norms one; the MoE and SSM blocks'
    as ``moe.init_moe`` and ``ssm.init_ssm`` say."""
    _check_ported(cfg)
    device = gen.device
    embed = init_embed(gen, cfg, device)
    layers = [_new_layer(cfg, layer_spec(cfg, i), device, gen)
              for i in range(cfg.n_layers)]
    params = Transformer(cfg, embed, layers, device)
    params.final_norm.fill_(1.0)
    if not cfg.tie_embeddings:
        dense_init(gen, params.lm_head, scale=0.02)
    return params


def _mixer_block(spec: LayerSpec, lp: Layer, x: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    if spec.kind == "ssm":
        return SSM.ssm_forward(lp.mixer, x, cfg)[0]
    return A.self_attention(lp.mixer, x, cfg)[0]


def _ffn_block(spec: LayerSpec, lp: Layer, x: torch.Tensor,
               cfg: ModelConfig, full_capacity: bool = False):
    """(x after the layer's FFN, its MoE aux loss or 0.0)."""
    if not spec.has_ffn:
        return x, 0.0
    if spec.moe:
        return MOE.moe_ffn(lp.ffn, x, cfg, full_capacity=full_capacity)
    return mlp(lp.ffn, x, cfg), 0.0


def _layer(spec: LayerSpec, lp: Layer, x: torch.Tensor, cfg: ModelConfig):
    return _ffn_block(spec, lp, _mixer_block(spec, lp, x, cfg), cfg)


def _remat(fn, *args):
    # the model draws no random numbers, so no RNG state is kept
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def backbone(params: Transformer, x: torch.Tensor, cfg: ModelConfig
             ) -> tuple[torch.Tensor, torch.Tensor | float]:
    """Embedded inputs -> (final normed hidden states, the MoE aux loss
    summed over the layers; 0.0 without MoE layers).

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
            x, a = _layer(spec, lp, x, cfg)
        elif cfg.remat_policy == "all":
            x, a = _remat(_layer, spec, lp, x, cfg)
        else:
            x = _remat(_mixer_block, spec, lp, x, cfg)
            x, a = _remat(_ffn_block, spec, lp, x, cfg)
        aux = aux + a
    return rms_norm(x, params.final_norm, cfg.norm_eps), aux


def logits_from_hidden(params: Transformer, x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """The output head: the token embedding transposed when tied, else
    ``lm_head``."""
    if cfg.tie_embeddings:
        return x @ params.embed.tokens.to(x.dtype).T
    return x @ params.lm_head.to(x.dtype)


def forward_train(params: Transformer, tokens: torch.Tensor,
                  cfg: ModelConfig):
    """tokens (B, S) -> (full-sequence logits (B, S, vocab), MoE aux
    loss)."""
    x, aux = backbone(params, embed_tokens(params.embed, tokens, cfg), cfg)
    return logits_from_hidden(params, x, cfg), aux


def _ce_sum(params: Transformer, x: torch.Tensor, targets: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    logits = logits_from_hidden(params, x, cfg).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - tgt).sum()


def lm_loss(params: Transformer, tokens: torch.Tensor,
            targets: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy (float32) + 0.01 · the MoE aux
    loss."""
    x, aux = backbone(params, embed_tokens(params.embed, tokens, cfg), cfg)
    if cfg.loss_vocab_chunk:
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
    Hkv, hd) for attention layers, a zeroed ``SSMState`` (conv tails in
    ``dtype``, the state in float32) for SSM layers."""
    dtype = dtype or cfg.adtype()
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return [SSM.init_ssm_state(cfg, batch, dtype, device)
            if layer_spec(cfg, i).kind == "ssm" else
            {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for i in range(cfg.n_layers)]


@torch.no_grad()
def prefill(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int | None = None):
    """Process a prompt: (last-position logits (B, 1, vocab), caches: KV
    padded to ``max_len``, SSM states after the prompt).  The MoE layers
    run at ``capacity_factor``, as the reference's prefill."""
    S = tokens.shape[1]
    pad = (max_len or S) - S
    x = embed_tokens(params.embed, tokens, cfg)
    cache = []
    for i, lp in enumerate(params.layers):
        spec = layer_spec(cfg, i)
        if spec.kind == "ssm":
            x, st = SSM.ssm_forward(lp.mixer, x, cfg, return_state=True)
            cache.append(st)
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
    """One decode step: tokens (B, 1), pos (B,) -> (logits (B, 1, vocab),
    cache updated in place).  The MoE layers run at full capacity (no
    drops), as the reference's decode."""
    x = embed_tokens(params.embed, tokens, cfg)
    for i, lp in enumerate(params.layers):
        spec = layer_spec(cfg, i)
        lc = cache[i]
        if spec.kind == "ssm":
            x, cache[i] = SSM.ssm_decode_step(lp.mixer, x, lc, cfg)
        else:
            x, lc["k"], lc["v"] = A.decode_self_attention(
                lp.mixer, x, lc["k"], lc["v"], pos, cfg)
        x, _ = _ffn_block(spec, lp, x, cfg, full_capacity=True)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_from_hidden(params, x, cfg), cache
