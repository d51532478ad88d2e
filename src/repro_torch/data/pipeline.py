"""Deterministic synthetic token stream (the numpy part of the reference's
``repro/data/pipeline.py``).

The corpus is a seeded Zipf-ish token stream generated per (step, position)
with a counter-based hash, so a batch is a pure function of its config and
step.  Sampled evaluation folds it into an operand histogram
(``core.sampling.empirical_histogram``); ``_hash_u32`` is also the counter
hash of the sample streams.  The prefetching loader and document packing
belong to training and are not here.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    n_codebooks: int = 0      # audio: tokens get a trailing codebook dim
    zipf_alpha: float = 1.1


def _hash_u32(x: np.ndarray) -> np.ndarray:
    """Counter-based integer hash (xorshift-mult mix), vectorized."""
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> np.uint64(33)
    return (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _zipf_map(u: np.ndarray, vocab: int, alpha: float) -> np.ndarray:
    """Map uniform u32 to a Zipf-ish (log-uniform) rank over [0, vocab):
    P(id = r) ∝ 1/(r+1), by the inverse CDF id = floor(V^f) - 1."""
    f = (u.astype(np.float64) + 1.0) / 2**32
    r = np.power(float(vocab), f)          # in (1, vocab]
    return np.minimum(r.astype(np.int64) - 1, vocab - 1).astype(np.int32)


def synth_batch(cfg: DataConfig, step: int,
                host_slice: slice | None = None) -> dict:
    """Batch for ``step``: {'tokens': (B, S[, C]), 'targets': same}."""
    B, S = cfg.global_batch, cfg.seq_len
    rows = np.arange(B)[host_slice] if host_slice else np.arange(B)
    C = max(1, cfg.n_codebooks)
    pos = (np.uint64(cfg.seed) << np.uint64(48)) \
        + (np.uint64(step) << np.uint64(28))
    idx = (pos + (rows[:, None, None].astype(np.uint64) << np.uint64(16))
           + np.arange(S, dtype=np.uint64)[None, :, None] * np.uint64(C)
           + np.arange(C, dtype=np.uint64)[None, None, :])
    toks = _zipf_map(_hash_u32(idx), cfg.vocab, cfg.zipf_alpha)
    if cfg.n_codebooks == 0:
        toks = toks[..., 0]
    # next-token targets within the synthetic stream
    tgt = np.roll(toks, -1, axis=1)
    return {"tokens": toks, "targets": tgt}
