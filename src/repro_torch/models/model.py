"""Dense decoder-only LM: parameters, forward, loss, prefill and decode.

The port of ``repro/models/model.py``'s dense path (GQA attention + SwiGLU
MLP per layer).  ``Transformer`` holds the parameters as ``nn.Module``s on
an explicit device and dtype; the apply functions mirror the reference's
names.  Layers are walked with a Python loop (the reference scans over
periods stacked on a leading axis; ``convert.model_params`` unstacks
them).  Caches are a list with one ``{"k", "v"}`` dict per layer, each
(B, max_len, Hkv, hd); ``decode_step`` updates them in place.  MoE, SSM,
cross-attention and the audio / vision front ends are not ported
(ROADMAP A13) and raise.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models.layers import (MLP, Embed, embed_tokens, init_embed,
                                       init_mlp, mlp, param, rms_norm)


class Layer(nn.Module):
    def __init__(self, mixer: A.Attention, ffn: MLP):
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


def _check_dense(cfg: ModelConfig) -> None:
    bad = [s for s in cfg.period if not s.dense]
    if bad:
        raise NotImplementedError(
            f"{cfg.name}: only dense attention + FFN layers are ported "
            f"(ROADMAP A13), got {bad}")


def skeleton(cfg: ModelConfig, device) -> Transformer:
    """An uninitialized ``Transformer`` of ``cfg`` on ``device``."""
    _check_dense(cfg)
    layers = [Layer(A.Attention(cfg, device), MLP(cfg, device))
              for _ in range(cfg.n_layers)]
    return Transformer(cfg, Embed(cfg, device), layers, device)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random parameters from ``gen``, on the generator's device, with the
    reference's distributions: projections N(0, 1/d_in), the embedding
    N(0, 0.02²), norms one."""
    _check_dense(cfg)
    device = gen.device
    embed = init_embed(gen, cfg, device)
    layers = [Layer(A.init_attention(gen, cfg, device),
                    init_mlp(gen, cfg, device)) for _ in range(cfg.n_layers)]
    params = Transformer(cfg, embed, layers, device)
    params.final_norm.fill_(1.0)
    return params


def backbone(params: Transformer, x: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    """Embedded inputs -> final normed hidden states."""
    for lp in params.layers:
        x, _ = A.self_attention(lp.mixer, x, cfg)
        x = mlp(lp.ffn, x, cfg)
    return rms_norm(x, params.final_norm, cfg.norm_eps)


def logits_from_hidden(params: Transformer, x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    """The output head, tied to the token embedding."""
    return x @ params.embed.tokens.to(x.dtype).T


def _ce_sum(params: Transformer, x: torch.Tensor, targets: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    logits = logits_from_hidden(params, x, cfg).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
    return (lse - tgt).sum()


def lm_loss(params: Transformer, tokens: torch.Tensor,
            targets: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy (float32)."""
    x = embed_tokens(params.embed, tokens, cfg)
    x = backbone(params, x, cfg)
    if cfg.loss_vocab_chunk:
        return _chunked_ce(params, x, targets, cfg)
    return _ce_sum(params, x, targets, cfg) / targets.numel()


def _chunked_ce(params: Transformer, x: torch.Tensor, targets: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Cross-entropy over sequence chunks of ``loss_vocab_chunk`` positions,
    so (B, S, vocab) logits never exist at once.  As the reference, the
    positions past the last whole chunk are left out; a sequence shorter
    than one chunk is one chunk (the reference's reshape fails there)."""
    B, S, _ = x.shape
    C = min(cfg.loss_vocab_chunk, S)
    n = S // C
    total = sum(_ce_sum(params, x[:, i * C:(i + 1) * C],
                        targets[:, i * C:(i + 1) * C], cfg)
                for i in range(n))
    return total / (B * n * C)


# ------------------------------- caches -------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype | None = None, device=None) -> list[dict]:
    """Zeroed per-layer KV caches, (batch, max_len, Hkv, hd) each."""
    dtype = dtype or cfg.adtype()
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.n_layers)]


def prefill(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            max_len: int | None = None):
    """Process a prompt: (last-position logits (B, 1, vocab), caches padded
    to ``max_len``)."""
    S = tokens.shape[1]
    pad = (max_len or S) - S
    x = embed_tokens(params.embed, tokens, cfg)
    cache = []
    for lp in params.layers:
        x, (k, v) = A.self_attention(lp.mixer, x, cfg)
        if pad > 0:
            k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
            v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        cache.append({"k": k, "v": v})
        x = mlp(lp.ffn, x, cfg)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_from_hidden(params, x[:, -1:], cfg), cache


def decode_step(params: Transformer, cache: list[dict], tokens: torch.Tensor,
                pos: torch.Tensor, cfg: ModelConfig):
    """One decode step: tokens (B, 1), pos (B,) -> (logits (B, 1, vocab),
    cache updated in place)."""
    x = embed_tokens(params.embed, tokens, cfg)
    for lp, lc in zip(params.layers, cache):
        x, lc["k"], lc["v"] = A.decode_self_attention(
            lp.mixer, x, lc["k"], lc["v"], pos, cfg)
        x = mlp(lp.ffn, x, cfg)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return logits_from_hidden(params, x, cfg), cache
