"""Model FLOPs of a dense decoder step, from the configuration's sizes: 2
per multiply-add of every projection (query, key, value, output, the
MLP's gate, up and down, and the output head; the projections the
approximate multiplier emulates count as the products they stand for) and
4·Hq·head_dim per scored (query, key) pair."""
from __future__ import annotations

from bench.workmodels.flash_attention import pairs


def projection_macs(s: dict) -> int:
    """Multiply-adds of one token through every projection and the
    head."""
    d, hd = s["hidden_size"], s["head_dim"]
    q, kv = s["num_attention_heads"] * hd, s["num_key_value_heads"] * hd
    layer = d * (2 * q + 2 * kv) + 3 * d * s["intermediate_size"]
    return s["num_hidden_layers"] * layer + d * s["vocab_size"]


def forward_flops(s: dict, batch: int, seq: int) -> float:
    """A causal forward of ``batch`` sequences of ``seq`` tokens."""
    attn = (4 * s["num_attention_heads"] * s["head_dim"]
            * s["num_hidden_layers"] * batch * pairs(seq, seq))
    return 2 * projection_macs(s) * batch * seq + attn


def decode_flops(s: dict, batch: int, context: int) -> float:
    """One decode step of ``batch`` sessions, each scoring ``context``
    positions (its cache and the new token)."""
    attn = (4 * s["num_attention_heads"] * s["head_dim"]
            * s["num_hidden_layers"] * batch * context)
    return 2 * projection_macs(s) * batch + attn
