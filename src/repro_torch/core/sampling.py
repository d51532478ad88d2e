"""Sampled, distribution-weighted evaluation inputs (a copy of the
reference's ``repro/core/sampling.py``).

Exhaustive evaluation scores every candidate on the full 2^(2w) input cube,
which stops being tractable around width 10-12 (width 12 is 16.7M rows a
candidate).  This module draws a deterministic SAMPLE of operand pairs from
a chosen input distribution and packs it into the same ``(n_i, W)``
bit-plane / ``(W*32,)`` golden-value contract the cube uses, so everything
downstream (the cgp_sim kernel, the cube-sharded all-reduce, the batched
sweep) runs unchanged: integer metric partials stay exact on the sample,
and the second-moment partials give standard errors per metric
(``metrics.metric_stderr``).

Determinism: operands come from counter-based streams (the
``data.pipeline._hash_u32`` mix) indexed by ``(sample_seed, stream, row)``,
so a sample is a pure function of ``(width, sample_size, input_dist,
sample_seed)``; ``stream_fingerprint`` names it (the same hex digest as the
reference's, so it enters the grid fingerprint identically).

Distributions (``input_dist``):

  * ``"uniform"``   — each operand i.i.d. uniform over [0, 2^w);
  * ``"gaussian"``  — Box-Muller on two hash streams, centered at
    (2^w - 1)/2, σ = 2^w/6, clipped to [0, 2^w);
  * ``"empirical"`` — inverse-CDF draws from a histogram of the
    ``data.pipeline`` synthetic token stream (``empirical_histogram``).

Sample sizes round UP so the packed word count is a power of two: it then
splits evenly over any power-of-two cube sharding.
``effective_sample_size`` gives the materialized row count.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np

from repro_torch.data.pipeline import DataConfig, _hash_u32, synth_batch

INPUT_DISTS = ("uniform", "gaussian", "empirical")

# stream tags keep the operand-a / operand-b / auxiliary hash streams
# disjoint inside one (sample_seed, row) counter space
_STREAM_A, _STREAM_B, _STREAM_A2, _STREAM_B2 = range(4)


def effective_sample_size(sample_size: int) -> int:
    """Materialized rows: sample_size rounded up to a pow2 multiple of 32."""
    if sample_size < 1:
        raise ValueError(f"sample_size must be >= 1, got {sample_size}")
    n_words = max((sample_size + 31) // 32, 1)
    n_words = 1 << (n_words - 1).bit_length()
    return n_words * 32


def _stream_u32(seed: int, stream: int, n: int) -> np.ndarray:
    """(n,) uint32 from the counter-based hash: lane (seed, stream, row)."""
    base = (np.uint64(seed) << np.uint64(34)) \
        + (np.uint64(stream) << np.uint64(32))
    return _hash_u32(base + np.arange(n, dtype=np.uint64))


def _uniform_operand(seed: int, stream: int, n: int, width: int) -> np.ndarray:
    return (_stream_u32(seed, stream, n) >> np.uint32(32 - width)).astype(
        np.int64)


def _gaussian_operand(seed: int, stream: int, stream2: int, n: int,
                      width: int) -> np.ndarray:
    """Box-Muller on two u32 streams -> N(center, (2^w/6)^2), clipped."""
    u1 = (_stream_u32(seed, stream, n).astype(np.float64) + 0.5) / 2**32
    u2 = (_stream_u32(seed, stream2, n).astype(np.float64) + 0.5) / 2**32
    z = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
    hi = (1 << width) - 1
    vals = np.rint(hi / 2.0 + z * ((1 << width) / 6.0))
    return np.clip(vals, 0, hi).astype(np.int64)


def empirical_histogram(width: int, seed: int = 0,
                        n_batches: int = 4) -> np.ndarray:
    """(2^w,) operand-value counts captured from the data pipeline.

    The synthetic corpus's Zipf-ish token stream stands in for real
    activation traffic: token ids fold into the operand range (mod 2^w), so
    low values dominate like quantized NN activations do.  Deterministic in
    ``(width, seed, n_batches)`` — the pipeline itself is counter-based.
    """
    n_vals = 1 << width
    cfg = DataConfig(vocab=32000, seq_len=1024, global_batch=8, seed=seed)
    counts = np.zeros(n_vals, np.int64)
    for step in range(n_batches):
        toks = synth_batch(cfg, step)["tokens"].reshape(-1)
        counts += np.bincount(toks % n_vals, minlength=n_vals)
    return counts


def _empirical_operand(seed: int, stream: int, n: int, width: int,
                       hist: np.ndarray) -> np.ndarray:
    """Inverse-CDF draw from a (2^w,) histogram via one u32 stream."""
    if hist.shape != (1 << width,):
        raise ValueError(f"histogram shape {hist.shape} != {(1 << width,)}")
    total = int(hist.sum())
    if total <= 0:
        raise ValueError("empirical histogram is empty")
    cdf = np.cumsum(hist.astype(np.float64)) / total
    u = (_stream_u32(seed, stream, n).astype(np.float64) + 0.5) / 2**32
    return np.searchsorted(cdf, u, side="left").clip(0, (1 << width) - 1) \
        .astype(np.int64)


def sampled_operands(width: int, sample_size: int, input_dist: str,
                     sample_seed: int = 0,
                     empirical_hist: np.ndarray | None = None
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic (a, b) operand sample, each (effective_sample_size,).

    Pure function of its arguments (plus the histogram for
    ``"empirical"``, itself deterministic via ``empirical_histogram``).
    Operands a and b draw from disjoint hash streams, so they are
    independent even at equal row indices.
    """
    if input_dist not in INPUT_DISTS:
        raise ValueError(
            f"input_dist must be one of {INPUT_DISTS}, got {input_dist!r}")
    n = effective_sample_size(sample_size)
    if input_dist == "uniform":
        a = _uniform_operand(sample_seed, _STREAM_A, n, width)
        b = _uniform_operand(sample_seed, _STREAM_B, n, width)
    elif input_dist == "gaussian":
        a = _gaussian_operand(sample_seed, _STREAM_A, _STREAM_A2, n, width)
        b = _gaussian_operand(sample_seed, _STREAM_B, _STREAM_B2, n, width)
    else:  # empirical
        if empirical_hist is None:
            empirical_hist = empirical_histogram(width, seed=sample_seed)
        a = _empirical_operand(sample_seed, _STREAM_A, n, width,
                               empirical_hist)
        b = _empirical_operand(sample_seed, _STREAM_B, n, width,
                               empirical_hist)
    return a, b


def pack_sample_planes(a: np.ndarray, b: np.ndarray,
                       width: int) -> np.ndarray:
    """(2*width, n_rows/32) int32 bit-planes of sampled operand rows.

    Mirrors ``simulate.input_planes_np`` packing with the exhaustive index
    ``x = a + (b << width)``: bit ``l`` of word ``w`` in plane ``i`` is bit
    ``i`` of row ``32*w + l``'s x — planes [0, w) are operand a's bits,
    planes [w, 2w) operand b's.
    """
    if a.shape != b.shape or a.ndim != 1 or a.size % 32:
        raise ValueError(f"need equal 1-D operands, length % 32 == 0; got "
                         f"{a.shape} / {b.shape}")
    xs = (a.astype(np.uint64) | (b.astype(np.uint64) << np.uint64(width)))
    planes = []
    for i in range(2 * width):
        bits = ((xs >> np.uint64(i)) & np.uint64(1)).astype(np.uint32)
        words = bits.reshape(-1, 32)
        packed = (words << np.arange(32, dtype=np.uint32)[None, :]).sum(
            axis=1, dtype=np.uint32)
        planes.append(packed)
    return np.stack(planes).astype(np.int32)  # two's complement reinterpret


def sampled_golden_values(a: np.ndarray, b: np.ndarray,
                          kind: str) -> np.ndarray:
    """int32 exact golden outputs on the sample rows (mirrors
    ``golden.golden_values`` semantics, sample-indexed instead of
    cube-indexed)."""
    if kind == "mul":
        return (a * b).astype(np.int32)
    if kind == "add":
        return (a + b).astype(np.int32)
    raise ValueError(kind)


def sample_problem(width: int, kind: str, sample_size: int, input_dist: str,
                   sample_seed: int = 0
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(in_planes (2w, W), golden_vals (W*32,)) for one sample stream —
    drop-in for the exhaustive ``(input_planes, golden_values)`` pair."""
    a, b = sampled_operands(width, sample_size, input_dist, sample_seed)
    return pack_sample_planes(a, b, width), sampled_golden_values(a, b, kind)


def stream_fingerprint(width: int, sample_size: int, input_dist: str,
                       sample_seed: int = 0) -> str:
    """Identity of one sample stream (hex digest).

    Everything that changes the materialized rows is in here — incorporate
    it into any cache/checkpoint key whose values depend on WHICH inputs a
    circuit was measured on (the phenotype-dedup cache scope, the sweep grid
    fingerprint).  ``sample_size`` enters as its effective (rounded) value,
    so two nominal sizes that materialize identical rows share entries.
    """
    ident = {
        "width": width,
        "effective_sample_size": effective_sample_size(sample_size),
        "input_dist": input_dist,
        "sample_seed": sample_seed,
        "stream": "hash_u32/v1",
    }
    return hashlib.sha256(
        json.dumps(ident, sort_keys=True).encode()).hexdigest()
