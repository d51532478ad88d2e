"""Counter-based PRNG: the ``jax.random`` stream the reference sweep draws.

The sweep defines a run's result as a function of ``PRNGKey(seed)`` alone,
so the port reproduces JAX's default generator bit for bit instead of using
a ``torch.Generator``: ``threefry2x32`` with ``jax_threefry_partitionable``
on (JAX's default).  Only the calls the evolution path makes are covered:

  * ``PRNGKey(seed)``;
  * ``split(key, n)``, for a key with any leading batch dims;
  * ``fold_in(key, data)``, ``data`` an integer or an integer tensor;
  * ``randint(key, shape, minval, maxval)``, ``maxval`` may be an array
    broadcast against ``shape`` (per-gene fan-in bounds);
  * ``bernoulli(key, p, shape)`` at float32.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words.  All
arithmetic is int64 masked to 32 bits: torch has no uint32 shifts on the
CPU.  Leading key dims broadcast against the drawn shape, so one call draws
for a whole batch of keys (the reference's ``vmap`` over keys).
"""
from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the counter pair ``(x1, x2)``; operands
    are int64 tensors of uint32 values and broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def PRNGKey(seed: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """(2,) key of a 32-bit seed: (0, seed as uint32), as JAX builds it
    with 64-bit types off."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _hash(key: torch.Tensor, shape: tuple[int, ...]
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry of the row-major counters 0..prod(shape)-1 under ``key``
    (..., 2); returns two (..., *shape) word tensors."""
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    lo = (counts & _MASK).reshape(shape)
    hi = (counts >> 32).reshape(shape)
    expand = (slice(None),) * (key.dim() - 1) + (None,) * len(shape)
    return threefry2x32(key[..., 0][expand], key[..., 1][expand], hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """(..., 2) -> (..., num, 2) new keys."""
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """JAX's ``fold_in``: the threefry hash of the counter pair
    ``(0, data as uint32)`` under ``key``.  ``data`` may be a tensor, which
    broadcasts against the key's leading dims: (..., 2) new keys."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _MASK
    x1, x2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([x1, x2], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """32 uniform random bits per element: (..., *shape) int64."""
    b1, b2 = _hash(key, tuple(shape))
    return b1 ^ b2


def randint(key: torch.Tensor, shape: tuple[int, ...], minval,
            maxval) -> torch.Tensor:
    """int32 values in [minval, maxval) with JAX's two-word modulus draw.

    ``maxval`` may be a tensor broadcast against ``shape``; the bounds must
    lie inside int32 (the reference's ``maxval_out_of_range`` branch is not
    reached by the evolution path and is not ported).
    """
    shape = tuple(shape)
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    lo = torch.as_tensor(minval, dtype=torch.int64, device=key.device)
    hi = torch.as_tensor(maxval, dtype=torch.int64, device=key.device)
    span = torch.where(hi <= lo, torch.ones_like(hi - lo), (hi - lo) & _MASK)
    multiplier = ((((1 << 16) % span) ** 2) & _MASK) % span
    # uint32 products wrap: the low 32 bits of the int64 product (which may
    # itself wrap mod 2^64) are the uint32 result
    offset = (((higher % span) * multiplier) & _MASK) + lower % span
    offset = (offset & _MASK) % span
    return (lo + offset).to(torch.int32)


def bernoulli(key: torch.Tensor, p: float, shape: tuple[int, ...]
              ) -> torch.Tensor:
    """``uniform(key, shape, float32) < float32(p)`` as a bool tensor.

    The uniform draw keeps the top 23 bits ``m`` of the random word and is
    ``m·2^-23`` exactly, so the comparison is made in float64 with no
    rounding on either side.
    """
    mant = random_bits(key, tuple(shape)) >> 9
    p32 = torch.tensor(p, dtype=torch.float32).item()
    return mant.to(torch.float64) * 2.0 ** -23 < p32
