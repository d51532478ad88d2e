"""Approximate-multiplier LUT matmul: the CUDA launch wrapper.

Replaces the TPU kernel ``repro/kernels/lut_matmul.py:29-83``
(``lut_matmul_kernel`` + ``lut_matmul``) and the padding of its ops wrapper
``repro/kernels/ops.py:161-187``.  It computes the function, not the Pallas
grid:

    C[m, n] = Σ_k LUT[A[m, k], B[k, n]]     A (M, K), B (K, N) uint8 → int32

every product of an int8 matmul looked up in an evolved multiplier's
256 × 256 product table, so a model runs on the circuit's exact arithmetic.

What bounds it on an H100: operations.  Each product is one data-dependent
gather from the table in shared memory (one load on the load/store pipe,
32 lanes per clock per SM) plus an index multiply-add and an int32 add;
operands are one byte each, so a prefill projection (128 × 2048 × 8192,
2.1·10^9 lookups) needs ~0.25 ms of gathers and moves only ~19 MB.  The
table is the design problem: as int32 it is 256 KB, over the 227 KB a block
may use.  Every 8×8 artifact comes from an n_o = 16 circuit (entries below
2^16; the exact table's largest is 65025), so the wrapper stages it as
uint16 — 128 KB, in dynamic shared memory — after checking every entry is in
[0, 65535], and raises otherwise.  Blocks are persistent (one per SM, the
table staged once per block) and walk (output tile, K slice) items; the K
slice count is chosen so that both prefill (M = 128) and decode (M = 4)
fill the 132 SMs, and slices add their int32 partials with atomics, which
is exact.  Lanes gather at data-dependent addresses, so bank conflicts
(about 3.5-way for random bytes) are expected and not avoided here; nor
is the 128 KB table load per block.  Edges are bounds-checked, so nothing
is padded and ``LUT[0, 0]`` needs no correction.

``lut_matmul`` takes CUDA tensors only; its plain version is
``ref.lut_matmul_ref``, which ``ops.lut_matmul`` takes for CPU tensors.
The source is built with nvcc for ``sm_90a`` at first use
(``kernels.nvcc``) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import nvcc

SOURCE = nvcc.CSRC / "lut_matmul.cu"
BK = 32                   # K steps per staged tile
MIN_SLICE_CHUNKS = 4      # a K slice spans at least 4 · BK = 128 steps
MAX_SPLITS = 64
SPLIT_GAIN = 0.05         # busy-share gain that justifies another split
TILES = {False: (64, 64), True: (4, 256)}  # strip? -> (BM, BN)

# Kernel launches made by ``lut_matmul`` in this process.
LAUNCHES = 0

_LIB = None


class Plan(NamedTuple):
    strip: bool           # 4-row strips (decode) instead of 64 × 64 tiles
    tiles_n: int
    n_tiles: int
    splits: int           # K slices per output tile
    chunks_per_split: int  # BK-step chunks per slice
    grid: int             # persistent blocks


@functools.lru_cache(maxsize=256)
def plan(M: int, N: int, K: int, sm_count: int) -> Plan:
    """Tiles, K split and grid for an (M, K) × (K, N) product.

    The split count raises the busy share of the SM-waves the items take
    (items / (waves · sm_count)); a further split must gain more than
    ``SPLIT_GAIN`` of it (every split adds an atomic per output and a
    partial sum).  Each slice spans whole BK chunks, at least
    ``MIN_SLICE_CHUNKS`` of them."""
    strip = M < 32
    bm, bn = TILES[strip]
    tiles_n = -(-N // bn)
    n_tiles = -(-M // bm) * tiles_n
    chunks = -(-K // BK)
    best = None
    for s in range(1, min(MAX_SPLITS, max(1, chunks // MIN_SLICE_CHUNKS)) + 1):
        per = -(-chunks // s)
        splits = -(-chunks // per)     # no empty slices
        items = n_tiles * splits
        busy = items / (-(-items // sm_count) * sm_count)
        if best is None or busy > best[0] + SPLIT_GAIN:
            best = (busy, Plan(strip, tiles_n, n_tiles, splits, per,
                               min(items, sm_count)))
    return best[1]


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def build() -> nvcc.BuildInfo:
    """Compile ``csrc/lut_matmul.cu`` into a shared library (cached)."""
    return nvcc.build(SOURCE)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lut_matmul_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                          i, p]
        lib.lut_matmul_launch.restype = i
        lib.lut_matmul_error_string.argtypes = [i]
        lib.lut_matmul_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def stage_table(lut: torch.Tensor) -> torch.Tensor:
    """The kernel's table: a (256, 256) integer LUT as (65536,) int16 holding
    the uint16 bit patterns.  Raises if any entry is outside [0, 65535]:
    such a table does not fit the kernel, and nothing falls back."""
    if lut.shape != (256, 256) or lut.dtype.is_floating_point:
        raise TypeError(f"LUT must be a (256, 256) integer table, got "
                        f"{tuple(lut.shape)} {lut.dtype}")
    lo, hi = int(lut.min()), int(lut.max())
    if lo < 0 or hi > 0xFFFF:
        raise ValueError(f"LUT entries span [{lo}, {hi}], outside the "
                         f"uint16 range [0, 65535] the kernel stages in "
                         f"shared memory")
    wide = lut.reshape(-1).to(torch.int32)
    return torch.where(wide > 0x7FFF, wide - 0x10000, wide).to(torch.int16)


def lut_matmul(a: torch.Tensor, b: torch.Tensor,
               table: torch.Tensor) -> torch.Tensor:
    """C = Σ_k LUT[a[m, k], b[k, n]] on the card.

    Args:
      a: (M, K) uint8; b: (K, N) uint8; table: ``stage_table``'s (65536,)
        int16.  All contiguous, on one CUDA device.
    Returns (M, N) int32.  Raises for other dtypes, shapes and devices.
    """
    for name, x, dt in (("a", a, torch.uint8), ("b", b, torch.uint8),
                        ("table", table, torch.int16)):
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if table.shape != (256 * 256,):
        raise ValueError(f"table must be (65536,), got {tuple(table.shape)}")
    dev = a.device
    if dev.type != "cuda" or b.device != dev or table.device != dev:
        raise ValueError(f"no lut_matmul kernel for devices {a.device}, "
                         f"{b.device}, {table.device}")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    M, K = a.shape
    N = b.shape[1]
    if 0 in (M, N, K):
        raise ValueError(f"empty product ({M}, {K}) x ({K}, {N})")
    p = plan(M, N, K, _sm_count(dev.index if dev.index is not None
                                else torch.cuda.current_device()))
    c = (torch.zeros if p.splits > 1 else torch.empty)(
        (M, N), dtype=torch.int32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.lut_matmul_launch(
            a.data_ptr(), b.data_ptr(), table.data_ptr(), c.data_ptr(),
            M, N, K, int(p.strip), p.tiles_n, p.n_tiles, p.splits,
            p.chunks_per_split, p.grid, stream)
    if err != 0:
        raise RuntimeError("lut_matmul launch failed: "
                           + lib.lut_matmul_error_string(err).decode())
    global LAUNCHES
    LAUNCHES += 1
    return c
