"""Work model of one attention forward: 4·D FLOPs for each scored
(query, key) pair of each query head (QKᵀ and P·V) at the bf16 tensor
cores' dense peak, or q, k, v and the output read and written once at the
HBM rate, whichever is larger.  Under the causal mask query i scores keys
0..i."""
from __future__ import annotations

from bench.workmodels.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def pairs(Sq: int, Skv: int, causal: bool = True) -> int:
    if not causal:
        return Sq * Skv
    n = min(Sq, Skv)
    return n * (n + 1) // 2 + (Sq - n) * Skv


def bound_ms(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, D: int,
             itemsize: int, causal: bool = True) -> float:
    flops = 4 * B * Hq * D * pairs(Sq, Skv, causal)
    nbytes = itemsize * B * D * (2 * Hq * Sq + 2 * Hkv * Skv)
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
