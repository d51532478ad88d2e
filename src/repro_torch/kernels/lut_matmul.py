"""Approximate-multiplier LUT matmul: the CUDA launch wrapper.

Replaces the TPU kernel ``repro/kernels/lut_matmul.py:29-83``
(``lut_matmul_kernel`` + ``lut_matmul``) and the padding of its ops wrapper
``repro/kernels/ops.py:161-187``.  It computes the function, not the Pallas
grid:

    C[m, n] = Σ_k LUT[A[m, k], B[k, n]]     A (M, K), B (K, N) uint8 → int32

every product of an int8 matmul looked up in an evolved multiplier's
256 × 256 product table, so a model runs on the circuit's exact arithmetic.

What bounds it on an H100: shared memory.  A product read straight from
the 256 × 256 uint16 table in shared memory is a random gather: ~2.8
passes of the shared-memory pipe per 32 products on uniform bytes.  The
kernel (``csrc/lut_matmul.cu``, whose header gives the design) instead
gathers, per k, its BM rows' table rows into a slab indexed by b, so one 8-
or 16-byte read gives BM products; two products go into one 32-bit add.  A
block owns BM = 4 (decode, M ≤ 4) or 8 rows and BN = 512, 1024 or 2048
columns; the table is staged in each block's shared memory by bulk copies
while the A / B chunks of BK = 8 k stream through a cp.async ring; the K
slices of a tile are the blocks of one cluster and add their partial tiles
through distributed shared memory, so C is allocated with
``torch.empty``.  Only where a tile takes more slices than a cluster holds
do the clusters add into C atomically, after the launcher zeroes it on the
stream.  The table's entries must lie in [0, 65535] (uint16);
``stage_table`` raises otherwise.  Edges are bounds-checked, so nothing is
padded and ``LUT[0, 0]`` needs no correction.

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
# Mirrors of the source's constants (``Geo``; ``chip_smoke.py`` holds them
# equal to the built library's)
BK = 8                    # k a chunk: one slab per warp
TABLE_BYTES = 256 * 256 * 2
SMEM_LIMIT = 232448       # shared memory a block may use on an H100
TNS = (2, 4, 8)           # columns a thread: BN = 256 · TN
CLUSTERS = (1, 2, 4, 8)   # blocks a cluster (8 is the portable limit)
# A model of a launch's time in SM clocks, to choose among plans: a chunk's
# shared-memory passes (slab reads at READ_PASSES per 32 products on
# uniform bytes, per k a slab build's 9 · BM), PASS_CLOCKS clocks each; an
# item's fixed cost (start, first loads, epilogue); each atomic add into C,
# which lands on outputs the other groups add to; zeroing C.  Fitted to
# the plan sweep of tools/lut_matmul_ablation.py on an H100.
READ_PASSES = {4: 1.10, 8: 0.81}
PASS_CLOCKS = 1.6
ITEM_CLOCKS = 9000
ATOMIC_CLOCKS = 0.021
FILL_CLOCKS = 1800

# Kernel launches made by ``lut_matmul`` in this process.
LAUNCHES = 0

_LIB = None


class Geometry(NamedTuple):
    """Shared memory of one (BM, TN) instantiation, as ``Geo`` lays it out:
    the table, BK padded slabs, the ring of stages (B tile, A tile), the
    mbarrier.  The partial tile reuses the slabs and the ring."""
    bn: int
    slab_k: int        # one k's slab: RB · (256 + 32) bytes, RB = 2 · BM
    stage: int         # BK · BN + BM · BK bytes
    stages: int
    smem: int


@functools.lru_cache(maxsize=None)
def geometry(bm: int, tn: int) -> Geometry:
    bn, rb = 256 * tn, 2 * bm
    slab_k = rb * (256 + 32)
    stage = BK * bn + bm * BK
    ring = TABLE_BYTES + BK * slab_k
    stages = 4 if ring + 4 * stage + 16 <= SMEM_LIMIT else 3
    return Geometry(bn, slab_k, stage, stages, ring + stages * stage + 16)


def slab_offset(b, bm: int):
    """Byte offset of slab row ``b`` within one k's slab: one row of
    padding after every eight, so a lane's eight transposing stores start
    at row 9 · lane and hit distinct banks."""
    return 2 * bm * (b + (b >> 3))


class Plan(NamedTuple):
    bm: int               # rows a tile: 4 (M ≤ 4) or 8
    tn: int               # columns a thread: BN = 256 · tn
    tiles_n: int
    n_tiles: int
    cs: int               # blocks a cluster: the K slices added in DSMEM
    groups: int           # clusters a tile; > 1 adds them atomically
    chunks: int           # BK-step chunks of K, dealt into cs · groups slices
    clusters: int         # persistent clusters launched

    @property
    def bn(self) -> int:
        return 256 * self.tn

    @property
    def splits(self) -> int:
        return self.cs * self.groups

    @property
    def grid(self) -> int:
        return self.clusters * self.cs

    @property
    def zero_fill(self) -> bool:
        return self.groups > 1

    def slice(self, split: int) -> tuple[int, int]:
        """Chunks [lo, hi) of K slice ``split``, as the kernel deals them."""
        return (split * self.chunks // self.splits,
                (split + 1) * self.chunks // self.splits)


def tile_shape(M: int, N: int) -> tuple[int, int]:
    """(BM, TN): 4 rows for decode (M ≤ 4), else 8; the narrowest of 512,
    1024, 2048 columns that covers N, 2048 past it."""
    bm = 4 if M <= 4 else 8
    tn = next((t for t in TNS if 256 * t >= N), TNS[-1])
    return bm, tn


def chunk_clocks(bm: int, tn: int) -> float:
    """Modelled SM clocks of one chunk of a (bm, 256 · tn) tile."""
    return PASS_CLOCKS * BK * (bm * 256 * tn * READ_PASSES[bm] / 32 + 9 * bm)


def candidates(M: int, N: int, K: int, sm_count: int,
               slots: tuple[tuple[int, int], ...] | None = None
               ) -> list[tuple[float, Plan]]:
    """Every launch plan of an (M, K) × (K, N) product with its modelled
    clocks: tiles of BM rows and any BN up to ``tile_shape``'s, the K
    chunks dealt into ``cs · groups`` ≤ chunks slices, clusters of the
    sizes ``slots`` names, at most as many as it says are resident at once
    (every size in CLUSTERS, ``sm_count // cs`` of them, without it)."""
    bm, tn_max = tile_shape(M, N)
    chunks = -(-K // BK)
    fit = dict(slots) if slots else {cs: sm_count // cs for cs in CLUSTERS}
    out = []
    for tn in (t for t in TNS if t <= tn_max):
        tiles_n = -(-N // (256 * tn))
        n_tiles = -(-M // bm) * tiles_n
        for cs in CLUSTERS:
            if fit.get(cs, 0) < 1:
                continue
            for groups in range(1, chunks // cs + 1):
                items = n_tiles * groups
                clusters = min(items, fit[cs])
                clocks = -(-items // clusters) * (
                    -(-chunks // (cs * groups)) * chunk_clocks(bm, tn)
                    + ITEM_CLOCKS)
                if groups > 1:
                    clocks += FILL_CLOCKS + ATOMIC_CLOCKS * (
                        groups * n_tiles * bm * 256 * tn)
                out.append((clocks, Plan(bm, tn, tiles_n, n_tiles, cs, groups,
                                         chunks, clusters)))
    return out


@functools.lru_cache(maxsize=256)
def plan(M: int, N: int, K: int, sm_count: int,
         slots: tuple[tuple[int, int], ...] | None = None) -> Plan:
    """The plan of least modelled clocks; ties go to fewer groups (atomic
    adds), then the larger cluster, then the wider tile."""
    found = candidates(M, N, K, sm_count, slots)
    if not found:
        raise ValueError(f"no launch plan for ({M}, {K}) x ({K}, {N}) on "
                         f"{sm_count} SMs")
    return min(found, key=lambda cp: (cp[0], cp[1].groups, -cp[1].cs,
                                      -cp[1].tn))[1]


def build() -> nvcc.BuildInfo:
    """Compile ``csrc/lut_matmul.cu`` into a shared library (cached)."""
    return nvcc.build(SOURCE)


def load(path) -> ctypes.CDLL:
    """A built library with its C interface typed."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lut_matmul_launch.argtypes = [p, p, p, p] + [i] * 11 + [p]
    lib.lut_matmul_launch.restype = i
    for name in ("lut_matmul_smem_bytes", "lut_matmul_stages"):
        getattr(lib, name).argtypes = [i, i]
        getattr(lib, name).restype = i
    lib.lut_matmul_max_clusters.argtypes = [i, i, i]
    lib.lut_matmul_max_clusters.restype = i
    lib.lut_matmul_error_string.argtypes = [i]
    lib.lut_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _library():
    global _LIB
    if _LIB is None:
        _LIB = load(build().path)
    return _LIB


@functools.lru_cache(maxsize=None)
def cluster_slots(index: int) -> tuple[tuple[int, int], ...]:
    """(cluster size, clusters resident at once) on CUDA device ``index``,
    from the occupancy API (every instantiation takes one block an SM)."""
    lib = _library()
    out = []
    with torch.cuda.device(index):
        for cs in CLUSTERS:
            n = lib.lut_matmul_max_clusters(8, 8, cs)
            if n < 0:
                raise RuntimeError(
                    "lut_matmul occupancy query failed: "
                    + lib.lut_matmul_error_string(-n).decode())
            out.append((cs, n))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(M: int, N: int, K: int, index: int) -> Plan:
    """``plan`` on CUDA device ``index``: its SMs and cluster slots."""
    return plan(M, N, K, _sm_count(index), cluster_slots(index))


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
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return launch(a, b, table, plan_for(M, N, K, index))


def launch(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor,
           p: Plan) -> torch.Tensor:
    """The kernel under plan ``p`` on operands ``lut_matmul`` has checked
    (the ablation tool also times other plans through it)."""
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=torch.int32, device=a.device)
    lib = _library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        err = lib.lut_matmul_launch(
            a.data_ptr(), b.data_ptr(), table.data_ptr(), c.data_ptr(),
            M, N, K, p.bm, p.tn, p.tiles_n, p.n_tiles, p.groups, p.cs,
            p.chunks, p.clusters, stream)
    if err != 0:
        raise RuntimeError("lut_matmul launch failed: "
                           + lib.lut_matmul_error_string(err).decode())
    global LAUNCHES
    LAUNCHES += 1
    return c
