"""Everything a run draws comes from ``--seed`` through these, each
stream named by tags so that no two share draws."""
from __future__ import annotations

import zlib

import numpy as np


def _entropy(seed: int, tags) -> list[int]:
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32] + [
        zlib.crc32(str(t).encode()) for t in tags]


def rng(seed: int, *tags) -> np.random.Generator:
    """A NumPy generator of the stream (seed, *tags)."""
    return np.random.default_rng(np.random.SeedSequence(_entropy(seed, tags)))


def words(seed: int, *tags_and_shape) -> np.ndarray:
    """uint32 words of the stream: ``words(seed, tag, ..., shape)``."""
    *tags, shape = tags_and_shape
    return rng(seed, *tags).integers(0, 1 << 32, shape, dtype=np.uint32)


def torch_generator(seed: int, device, *tags):
    """A ``torch.Generator`` on ``device`` seeded from the stream."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, *tags).integers(0, 1 << 63)))
    return g


def device_info(dev, peak: int) -> dict:
    """The result line's ``device`` of a run on ``dev``."""
    import torch
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}
