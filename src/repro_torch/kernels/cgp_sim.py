"""Fused CGP simulation + error-metric kernel: the CUDA launch wrapper.

Replaces the TPU kernels ``repro/kernels/cgp_sim.py:107-238``
(``_sim_block_partials`` with ``cgp_sim_kernel`` and
``cgp_sim_kernel_cube_major``, reached through ``cgp_sim_metrics_batched``
with ``layout="genome_major"`` or ``"cube_major"``, and with one genome
through ``cgp_sim_metrics``).  It computes the function, not the Pallas
grid: for R genomes over the whole input cube it walks the netlist over a
bit-packed wire plane, counts each gate's set bits, unpacks the outputs and
returns the error-metric partials of ``core.metrics.error_partials`` in raw
form (``RawSums``), which ``ops`` decodes.

What bounds it on an H100: integer operations.  The function needs, per
(genome, gate, word), about three 3-input logic ops (LOP3) and one add on
the int32 pipe and one popcount on the quarter-rate pipe; at the main path's
shape (R=256, n_n=400, W=2048 words) that is ~2·10^8 gate-words, ~0.05 ms on
either pipe, plus the per-input unpack and metric work, while the bytes it
must move (genomes, planes, golden values) are ~2 MB, under a microsecond.
``chip_smoke.py`` computes the bound from the run's shapes.  The design
keeps every intermediate on chip: one warp per block owns a 32-word tile,
the tile's whole wire plane ``[n_i + n_n][32]`` int32 (53 KB at 400 nodes)
sits in dynamic shared memory, and a thread touches only its own word's
column during the walk, so gates need no barrier.  The integer partials are
exact (per-block warp reductions, then integer atomics);
``rel_sum``/``sq_sum``/``rel_sq`` are computed per element in float32 as
the reference does, accumulated in float64 per (genome, run of tiles) and
reduced over runs in a fixed order, so a rerun gives the same bits.  It is
a simple design, a few percent of the bound: each gate rebuilds its four
lane masks from the truth table per word, each output bit is extracted on
its own, and the one-warp blocks (3 per SM) hide little latency.

The two layouts are two kernels over the same per-genome walk:

* ``"genome_major"``: one block per (run of tiles, genome), reading the
  cube's planes and golden values from device memory (where the 50 MB L2
  keeps them for the other genomes);
* ``"cube_major"``: one block per (run of tiles, group of ``r_tile``
  genomes); the block stages its run of planes and golden values in shared
  memory once (``n_i + 32`` ints per word: 6 KB per 32-word tile at width
  8, beside the 53 KB wire plane) and walks each genome of the group over
  it — the reference's cube block held resident while the genomes stream
  past.

The knobs keep the reference's names.  ``block_words`` is the cube words
one block covers: the run the cube-major block keeps resident in shared
memory (the genome-major block streams it through its one-tile wire plane).
``None`` takes ``tiles_per_block``'s run, sized for occupancy.  ``r_tile``
is the genomes that share one resident run in cube-major; genome-major
takes one genome per block and has no use for it (1).  The float rows are
summed per (genome, run), so they depend on the run alone: every variant
with the same runs gives bit-identical ``RawSums`` whatever its layout or
``r_tile`` — in particular both layouts with ``block_words=None``, unless
``tiles_per_block``'s run does not fit the cube-major block's shared memory
(width 10 at small R), where cube-major's default takes the longest run
that fits.  Variants whose runs differ (another ``block_words``) agree on
every integer exactly and on the float rows within float64 reassociation,
far inside rtol 1e-6.

The magnitude sums follow ``metrics._exact_sum``'s regimes: in the byte
regime the kernel returns the exact integer totals (one rounding to float32
reproduces the reference's split sum); in the per-bit regime it returns the
per-bit counts of |d|, max(d, 0) and max(-d, 0), which ``ops`` recombines in
the reference's float32 order.

Cube sharding (``cgp_sim_metrics_batched_sharded``) replaces the TPU
wrapper ``repro/kernels/cgp_sim.py:362`` (``cgp_sim_metrics_batched_sharded``,
reached through ``repro/kernels/ops.py:155``): every rank of a group
launches the same kernel on its word slice of the cube, and the raw sums
are all-reduced over the group before ``ops`` decodes them — SUM for the
magnitude sums (int64), the integer rows, the popcounts and the float64
rows, MAX for WCE.  The slice launch takes the magnitude regime of the
whole cube (``total_words``), so the integer rows and magnitude sums equal
the whole-cube launch's bit for bit, and the float rows differ from it by
float64 reassociation only.  The all-reduce is ``torch.distributed``,
playing the part ``psum``/``pmax`` play in the reference; the kernel body
is the one above.

``cgp_sim_metrics_batched`` takes CUDA tensors only; its plain version is
``ref.cgp_eval_ref``, which ``ops`` takes for CPU tensors (on a slice,
``ref.cgp_eval_ref_sharded``).  The CUDA source is built with ``nvcc`` for
``sm_90a`` at first use (``kernels.nvcc``) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.core import gates
from repro_torch.core import metrics as M
from repro_torch.kernels import nvcc

TILE = 32                      # words per tile = threads per block
N_INTS = 2 + M.N_BINS          # err_count, acc0_bad, hist[N_BINS]
MAX_SMEM_BYTES = 232_448       # per-block dynamic shared memory on sm_90
# magnitude rows of RawSums.mag
ABS, POS, NEG = range(3)
# float rows of RawSums.fsums
REL_SUM, SQ_SUM, REL_SQ = range(3)

SOURCE = nvcc.CSRC / "cgp_sim.cu"

LAYOUTS = ("genome_major", "cube_major")
DEFAULT_R_TILE = 8             # cube-major genomes per block by default

# Kernel launches made by ``cgp_sim_metrics_batched`` in this process: the
# genome-major kernel's and the cube-major kernel's; those of one genome
# (R = 1, the reference's ``cgp_sim_metrics``); and the slice launches made
# by ``cgp_sim_metrics_batched_sharded``.  The last two are also counted in
# the first two.
LAUNCHES = 0
CUBE_LAUNCHES = 0
SINGLE_LAUNCHES = 0
SHARDED_LAUNCHES = 0


class RawSums(NamedTuple):
    """The kernel's per-genome outputs (leading R)."""
    mag: torch.Tensor    # (R, 3, n_o | 1) int64: per-bit counts or totals
    ints: torch.Tensor   # (R, N_INTS) int32: err_count, acc0_bad, hist
    wce: torch.Tensor    # (R,) int32
    pops: torch.Tensor   # (R, n_n) int32 per-gate set-bit counts
    fsums: torch.Tensor  # (R, 3) float64: rel_sum, sq_sum, rel_sq


_LIB = None


def build() -> nvcc.BuildInfo:
    """Compile ``csrc/cgp_sim.cu`` into a shared library (cached by hash)."""
    return nvcc.build(SOURCE)


def _library():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cgp_sim_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                       ctypes.c_uint, ctypes.c_double, i,
                                       p, p, p, p, p, p]
        lib.cgp_sim_launch.restype = i
        lib.cgp_sim_error_string.argtypes = [i]
        lib.cgp_sim_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tiles_per_block(R: int, W: int, sm_count: int) -> int:
    """Cube tiles one block walks: enough blocks for ~8 per SM, and as many
    tiles per block as that leaves (fewer blocks, fewer atomics)."""
    n_tiles = -(-W // TILE)
    blocks_per_genome = min(n_tiles, max(1, -(-8 * sm_count // R)))
    return -(-n_tiles // blocks_per_genome)


def smem_bytes(n_i: int, n_n: int, n_o: int,
               run_tiles: int | None = None) -> int:
    """Dynamic shared memory of one block: the genome-major layout
    (``run_tiles=None``) or a cube-major block staging ``run_tiles`` tiles.
    The same sum as ``cgp_sim_smem_bytes`` / ``cgp_sim_cube_smem_bytes``
    in the CUDA source."""
    base = 16 * n_n + 4 * (n_i + n_n) * TILE + 4 * n_n + 4 * n_o
    return base + (4 * (n_i + 32) * run_tiles * TILE if run_tiles else 0)


def run_tiles(layout: str, block_words: int | None, R: int, W: int,
              n_i: int, n_n: int, n_o: int, sm_count: int) -> int:
    """Tiles per run (one block's share of the cube) for a variant.

    An explicit ``block_words`` must be a multiple of the 32-word tile or
    cover the whole cube; a cube-major run that does not fit in shared
    memory raises.  ``None`` takes ``tiles_per_block``'s run, which
    cube-major caps at the longest run that fits."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    n_tiles = -(-W // TILE)
    if block_words is None:
        tiles = tiles_per_block(R, W, sm_count)
        if layout == "cube_major":
            room = MAX_SMEM_BYTES - smem_bytes(n_i, n_n, n_o)
            tiles = max(1, min(tiles, room // (4 * (n_i + 32) * TILE)))
        return tiles
    if block_words < 1 or (block_words % TILE and block_words < W):
        raise ValueError(f"block_words={block_words} must be a positive "
                         f"multiple of {TILE} or cover the cube's {W} words")
    tiles = min(n_tiles, -(-block_words // TILE))
    if layout == "cube_major":
        need = smem_bytes(n_i, n_n, n_o, tiles)
        if need > MAX_SMEM_BYTES:
            raise ValueError(
                f"cube-major run of {tiles * TILE} words needs {need} B of "
                f"shared memory > {MAX_SMEM_BYTES}; use fewer block_words")
    return tiles


def _check(nodes, outs, in_planes, golden_vals, n_i, n_n, n_o):
    dev = nodes.device
    for name, x in (("nodes", nodes), ("outs", outs),
                    ("in_planes", in_planes), ("golden_vals", golden_vals)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, nodes on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    R = nodes.shape[0]
    W = in_planes.shape[-1]
    if nodes.shape != (R, n_n, 3) or outs.shape != (R, n_o):
        raise ValueError(f"genomes must be (R, {n_n}, 3) / (R, {n_o}), got "
                         f"{tuple(nodes.shape)} / {tuple(outs.shape)}")
    if in_planes.shape != (n_i, W) or golden_vals.shape != (32 * W,):
        raise ValueError(f"in_planes (n_i, W) and golden_vals (32*W,) "
                         f"mismatch: {tuple(in_planes.shape)}, "
                         f"{tuple(golden_vals.shape)}")
    if not 1 <= R <= 65535:
        raise ValueError(f"R={R} genomes outside the launchable 1..65535")
    if not 1 <= n_o <= 30:
        raise ValueError(f"n_o={n_o} outside 1..30")


def cgp_sim_metrics_batched(nodes: torch.Tensor, outs: torch.Tensor,
                            in_planes: torch.Tensor,
                            golden_vals: torch.Tensor, *, n_i: int, n_n: int,
                            n_o: int, gauss_sigma: float = 256.0,
                            layout: str = "genome_major",
                            block_words: int | None = None,
                            r_tile: int | None = None,
                            total_words: int | None = None) -> RawSums:
    """Fused evaluation of R stacked genomes over one input cube.

    Args:
      nodes: (R, n_n, 3) int32; outs: (R, n_o) int32 — legal genomes.
      in_planes: (n_i, W) int32; golden_vals: (32·W,) int32.
      layout: ``"genome_major"`` or ``"cube_major"`` (resolve ``"auto"``
        upstream, in ``ops.cgp_eval_batched``).
      block_words, r_tile: the variant's knobs (module docstring); ``None``
        takes the defaults (``tiles_per_block``'s run; ``DEFAULT_R_TILE``).
      total_words: the words of the whole cube when ``in_planes`` is a slice
        of it (default W): it fixes the magnitude regime.
    Returns ``RawSums``; the magnitude regime is ``metrics.exact_sum_per_bit
    (32·total_words, n_o)``.  Launches the kernel; raises for tensors not on
    CUDA.
    """
    _check(nodes, outs, in_planes, golden_vals, n_i, n_n, n_o)
    if nodes.device.type != "cuda":
        raise ValueError(f"no cgp_sim kernel for device {nodes.device}")
    cube = layout == "cube_major"
    dev = nodes.device
    R, W = nodes.shape[0], in_planes.shape[1]
    tpb = run_tiles(layout, block_words, R, W, n_i, n_n, n_o,
                    _sm_count(dev.index if dev.index is not None
                              else torch.cuda.current_device()))
    if cube:
        r_tile = DEFAULT_R_TILE if r_tile is None else r_tile
        if r_tile < 1:
            raise ValueError(f"r_tile must be positive, got {r_tile}")
    else:
        r_tile = 0     # the launcher's code for one genome per block
    smem = smem_bytes(n_i, n_n, n_o, tpb if cube else None)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"wire plane of {n_i + n_n} rows needs {smem} B of "
                         f"shared memory > {MAX_SMEM_BYTES}")
    if cube and -(-R // r_tile) > 65535:
        raise ValueError(f"{-(-R // r_tile)} genome groups exceed the grid")
    per_bit = M.exact_sum_per_bit(32 * (total_words or W), n_o)
    n_blocks = -(-(-(-W // TILE)) // tpb)
    mag = torch.zeros((R, 3, n_o if per_bit else 1), dtype=torch.int64,
                      device=dev)
    ints = torch.zeros((R, N_INTS), dtype=torch.int32, device=dev)
    wce = torch.zeros((R,), dtype=torch.int32, device=dev)
    pops = torch.zeros((R, n_n), dtype=torch.int32, device=dev)
    fpart = torch.empty((R, n_blocks, 3), dtype=torch.float64, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.cgp_sim_launch(
            nodes.data_ptr(), outs.data_ptr(), in_planes.data_ptr(),
            golden_vals.data_ptr(), R, n_i, n_n, n_o, W, tpb, r_tile,
            gates.TT_PACKED, float(gauss_sigma), int(per_bit),
            mag.data_ptr(), ints.data_ptr(), wce.data_ptr(), pops.data_ptr(),
            fpart.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("cgp_sim launch failed: "
                           + lib.cgp_sim_error_string(err).decode())
    global LAUNCHES, CUBE_LAUNCHES, SINGLE_LAUNCHES
    if cube:
        CUBE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    if R == 1:
        SINGLE_LAUNCHES += 1
    return RawSums(mag, ints, wce, pops, fpart.sum(dim=1))


def all_reduce_raw(raw: RawSums, group) -> RawSums:
    """The whole cube's ``RawSums`` from each rank's slice: SUM over
    ``group`` of the magnitude sums, integer rows, popcounts and float64
    rows, MAX of WCE; one collective per dtype and operation."""
    sum_ = dist.ReduceOp.SUM
    mag, = M.all_reduce_packed([raw.mag], sum_, group)
    ints, pops = M.all_reduce_packed([raw.ints, raw.pops], sum_, group)
    fsums, = M.all_reduce_packed([raw.fsums], sum_, group)
    wce, = M.all_reduce_packed([raw.wce], dist.ReduceOp.MAX, group)
    return RawSums(mag, ints, wce, pops, fsums)


def cgp_sim_metrics_batched_sharded(nodes: torch.Tensor, outs: torch.Tensor,
                                    in_planes: torch.Tensor,
                                    golden_vals: torch.Tensor, *, group,
                                    n_i: int, n_n: int, n_o: int,
                                    gauss_sigma: float = 256.0,
                                    layout: str = "genome_major",
                                    block_words: int | None = None,
                                    r_tile: int | None = None) -> RawSums:
    """``cgp_sim_metrics_batched`` on this rank's word slice of the cube,
    all-reduced over ``group`` (module docstring).

    ``in_planes`` (n_i, W/S) and ``golden_vals`` (32·W/S,) are this rank's
    slice, S the group's size; every rank holds an equal slice.  Returns the
    cube-global ``RawSums`` on every rank of the group.
    """
    global SHARDED_LAUNCHES
    if nodes.device.type != "cuda":
        raise ValueError(f"no cgp_sim kernel for device {nodes.device}")
    total = in_planes.shape[-1] * dist.get_world_size(group)
    raw = cgp_sim_metrics_batched(
        nodes, outs, in_planes, golden_vals, n_i=n_i, n_n=n_n, n_o=n_o,
        gauss_sigma=gauss_sigma, layout=layout, block_words=block_words,
        r_tile=r_tile, total_words=total)
    SHARDED_LAUNCHES += 1
    return all_reduce_raw(raw, group)
