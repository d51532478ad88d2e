"""Deterministic synthetic data pipeline and document packing (the port of
``repro/data/pipeline.py``; numpy only).

The corpus is a seeded Zipf-ish token stream generated per (step, position)
with a counter-based hash, so a batch is a pure function of its config and
step: a resumed run replays the exact batch sequence.  Training reads it
through ``synth_batch`` / ``batches`` / ``PrefetchLoader``; sampled
evaluation folds it into an operand histogram
(``core.sampling.empirical_histogram``); ``_hash_u32`` is also the counter
hash of the sample streams.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

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


def batches(cfg: DataConfig, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield synth_batch(cfg, step)
        step += 1


class PrefetchLoader:
    """Background-thread prefetch over ``batches`` (depth-bounded queue).

    ``close()`` stops the worker; a closed loader drains whatever was
    already queued and then raises ``StopIteration``: ``__next__`` polls
    with a timeout, so a ``close()`` issued while it waits is seen too, and
    it never blocks forever on a queue nobody refills.
    """

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put(synth_batch(self.cfg, step), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        while True:
            try:
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)


def pack_documents(docs: list[list[int]], seq_len: int,
                   eos: int) -> np.ndarray:
    """Pack variable-length documents into (N, seq_len) int32 rows with an
    EOS after each; long documents are split across rows, nothing is
    truncated, and the last row is padded with EOS."""
    flat: list[int] = []
    for d in docs:
        flat.extend(d)
        flat.append(eos)
    n = max(1, (len(flat) + seq_len - 1) // seq_len)
    out = np.full((n, seq_len), eos, dtype=np.int32)
    arr = np.asarray(flat[: n * seq_len], dtype=np.int32)
    out.reshape(-1)[: arr.size] = arr
    return out
