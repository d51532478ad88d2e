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

What bounds it on an H100: the SM's instruction issue and its
shared-memory pipe.  Per (genome, gate, word) the function needs two loads
and a store of the wire plane, three 3-input logic ops (LOP3) and one
popcount; at the main path's shape (R=256, n_n=400, W=2048 words) that is
~2·10^8 gate-words, ~0.075 ms of shared-memory accesses alone, plus the
per-input unpack and metric work, while the bytes it must move (genomes,
planes, golden values) are ~2 MB, under a microsecond.  ``chip_smoke.py``
computes the bound from the run's shapes.  The design keeps every
intermediate on chip (``csrc/cgp_sim.cu`` says how, step by step):

* blocks of up to ``MAX_WARPS`` warps share one staged genome, each warp
  with its own 32-word tile and wire plane ``[n_i + n_n][32]`` int32 (53 KB
  at 400 nodes), so 4 warps fill the SM's 227 KB at width 8;
* the block orders the genome's gates by topological level while staging
  them (no host work), as 16-byte entries that carry the rows' offsets and
  the gate's lane masks, and each warp walks a level in batches of
  ``BATCH`` gates, issuing every load of a batch before its stores;
* each gate's popcount over a tile is summed by one thread in a pass over
  the warp's plane without bank conflicts;
* each thread unpacks its word's 32 output values by a register bit
  transpose and computes their metrics itself.

The integer partials are exact (warp reductions, then integer atomics);
``rel_sum``/``sq_sum``/``rel_sq`` are computed per element in float32 as
the reference does, summed in float64 per (genome, tile) in a fixed order
and reduced over tiles in a fixed order, so a rerun gives the same bits.

The two layouts are two kernels over the same per-genome code:

* ``"genome_major"``: one block per (run of tiles, genome), reading the
  cube's planes and golden values from device memory (where the 50 MB L2
  keeps them for the other genomes);
* ``"cube_major"``: one block per (run of tiles, group of ``r_tile``
  genomes); the block stages its run of planes and golden values in shared
  memory once (``n_i + 32`` ints per word: 6 KB per 32-word tile at width
  8, beside the wire planes, so fewer planes fit) and walks each genome of
  the group over it — the reference's cube block held resident while the
  genomes stream past.

The knobs keep the reference's names.  ``block_words`` is the cube words
one block covers: the run the cube-major block keeps resident in shared
memory (the genome-major block streams it through its warps' planes).
``r_tile`` is the genomes that share one resident run in cube-major;
genome-major takes one genome per block and has no use for it (1).
``None`` takes the sizing rule's value (``tiles_per_block``,
``cube_defaults``): the grid is priced in whole waves of the resident
blocks the occupancy API reports, ``resident blocks an SM ×
multi_processor_count``, and the cheapest run (and group) wins.  The float
rows are summed per (genome, tile), so they do not depend on the variant:
every layout, run and group size gives bit-identical ``RawSums``.

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

TILE = 32                      # words per tile = threads per warp
N_INTS = 2 + M.N_BINS          # err_count, acc0_bad, hist[N_BINS]
MAX_SMEM_BYTES = 232_448       # per-block dynamic shared memory on sm_90
SM_SMEM_BYTES = 233_472        # shared memory an SM holds (1 KB a block
                               # reserved by the runtime)
MAX_WARPS = 4                  # warps a block (csrc/cgp_sim.cu MAX_WARPS)
BATCH = 4                      # gates walked together (... BATCH)
ENTRY_BYTES = 16               # a staged gate's entry (... ENT4 int4s)
# the sizing rule's costs, in one warp's walk of one tile: staging a
# genome (level sort, entries), and staging one tile of a cube-major run
STAGE_TILES = 0.25
RUN_STAGE_TILES = 0.05
# magnitude rows of RawSums.mag
ABS, POS, NEG = range(3)
# float rows of RawSums.fsums
REL_SUM, SQ_SUM, REL_SQ = range(3)

SOURCE = nvcc.CSRC / "cgp_sim.cu"

LAYOUTS = ("genome_major", "cube_major")
DEFAULT_R_TILE = None          # cube-major genomes per block: the rule's

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


class Geometry(NamedTuple):
    """How ``cgp_sim_metrics_batched`` launches a variant."""
    run_tiles: int       # tiles a block covers
    r_tile: int          # genomes a cube-major block walks (0: genome-major)
    blocks: int          # the grid's blocks
    occupancy: "Occupancy"


class Occupancy(NamedTuple):
    """What one launch configuration runs with on the card."""
    blocks_per_sm: int   # cudaOccupancyMaxActiveBlocksPerMultiprocessor
    warps: int           # warps a block
    registers: int       # registers a thread
    smem: int            # dynamic shared bytes a block


_LIB = None


def build() -> nvcc.BuildInfo:
    """Compile ``csrc/cgp_sim.cu`` into a shared library (cached by hash)."""
    return nvcc.build(SOURCE)


def load(path) -> ctypes.CDLL:
    """The kernel library at ``path`` with its C interface declared."""
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.cgp_sim_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                   ctypes.c_uint, ctypes.c_double, i,
                                   p, p, p, p, p, p]
    lib.cgp_sim_launch.restype = i
    lib.cgp_sim_error_string.argtypes = [i]
    lib.cgp_sim_error_string.restype = ctypes.c_char_p
    lib.cgp_sim_occupancy.argtypes = [i, i, i, i, i, i, p]
    lib.cgp_sim_occupancy.restype = i
    lib.cgp_sim_check_division.argtypes = [p, i, i, p, p]
    lib.cgp_sim_check_division.restype = i
    return lib


def _library():
    global _LIB
    if _LIB is None:
        _LIB = load(build().path)
    return _LIB


@functools.lru_cache(maxsize=None)
def occupancy(n_i: int, n_n: int, n_o: int, run_tiles: int, r_tile: int,
              per_bit: bool) -> Occupancy:
    """The card's occupancy of a launch (``r_tile`` 0: genome-major, else
    cube-major staging ``run_tiles`` tiles), from the CUDA runtime's
    occupancy API on the current device."""
    out = (ctypes.c_int * 4)()
    lib = _library()
    err = lib.cgp_sim_occupancy(n_i, n_n, n_o, run_tiles, r_tile,
                                int(per_bit), out)
    if err != 0:
        raise RuntimeError("cgp_sim occupancy query failed: "
                           + lib.cgp_sim_error_string(err).decode())
    return Occupancy(*out)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _ceil4(n: int) -> int:
    return (n + 3) & ~3


def block_warps(n_i: int, n_n: int, n_o: int,
                run_tiles: int | None = None) -> int:
    """Warps a block runs: as many wire planes as fit beside the staged
    genome (and a cube-major block's staged run of ``run_tiles`` tiles),
    at most ``MAX_WARPS``; 0 if not one fits.  ``block_warps`` in the CUDA
    source."""
    fixed = (ENTRY_BYTES * (n_n + BATCH) + 4 * _ceil4(n_n) + 4 * _ceil4(n_o)
             + (4 * (n_i + 32) * run_tiles * TILE if run_tiles else 0))
    if fixed >= MAX_SMEM_BYTES:
        return 0
    return min(MAX_WARPS, (MAX_SMEM_BYTES - fixed) // (4 * TILE * (n_i + n_n)))


def smem_bytes(n_i: int, n_n: int, n_o: int,
               run_tiles: int | None = None) -> int:
    """Dynamic shared memory of one block: the genome-major layout
    (``run_tiles=None``) or a cube-major block staging ``run_tiles`` tiles:
    the staged genome (16-byte entries, popcounts, output rows), the
    block's wire planes (one if none fits, so that the sum exceeds
    ``MAX_SMEM_BYTES``) and the staged run.  The same sum as
    ``cgp_sim_smem_bytes`` / ``cgp_sim_cube_smem_bytes`` in the CUDA
    source."""
    warps = max(1, block_warps(n_i, n_n, n_o, run_tiles))
    return (ENTRY_BYTES * (n_n + BATCH) + 4 * _ceil4(n_n) + 4 * _ceil4(n_o)
            + warps * 4 * TILE * (n_i + n_n)
            + (4 * (n_i + 32) * run_tiles * TILE if run_tiles else 0))


def blocks_by_smem(smem: int) -> int:
    """Resident blocks an SM by shared memory alone: the estimate where
    the occupancy API is not at hand (the CPU)."""
    return max(1, SM_SMEM_BYTES // (smem + 1024))


def wave_cost(R: int, n_tiles: int, tiles: int, warps: int, slots: int,
              r_tile: int = 1, staged: bool = False) -> tuple[float, int]:
    """(cost, blocks) of a grid: whole waves of ``slots`` resident blocks,
    each wave as long as its longest block — ``r_tile`` genomes, each
    staged and walked over ``tiles`` tiles by ``warps`` warps, plus the
    staged run (cube-major) — in units of one warp's walk of one tile."""
    blocks = -(-n_tiles // tiles) * -(-R // r_tile)
    per_block = r_tile * (-(-tiles // warps) + STAGE_TILES)
    if staged:
        per_block += RUN_STAGE_TILES * tiles
    return -(-blocks // max(1, slots)) * per_block, blocks


def _run_lengths(n_tiles: int) -> list[int]:
    """The distinct run lengths that cut ``n_tiles`` tiles into k runs."""
    return sorted({-(-n_tiles // k) for k in range(1, n_tiles + 1)})


@functools.lru_cache(maxsize=None)
def tiles_per_block(R: int, W: int, sm_count: int, blocks_per_sm: int = 1,
                    warps: int = MAX_WARPS) -> int:
    """Cube tiles one genome-major block walks: the run whose grid costs
    least in whole waves of ``blocks_per_sm × sm_count`` resident blocks
    (``wave_cost``), fewer blocks (fewer stagings and atomics) on a tie."""
    n_tiles = -(-W // TILE)
    slots = blocks_per_sm * sm_count
    return min(_run_lengths(n_tiles), key=lambda t: wave_cost(
        R, n_tiles, t, warps, slots))


def cube_defaults(R: int, W: int, n_i: int, n_n: int, n_o: int,
                  sm_count: int, occupancy=None) -> tuple[int, int]:
    """(run tiles, r_tile) of cube-major's defaults: the pair whose grid
    costs least in whole waves (``wave_cost``), over every run length
    whose staging leaves room for a wire plane and r_tile in 1, 2, 4, ...
    up to R; fewer blocks on a tie.  ``occupancy(run_tiles)`` gives the
    resident blocks an SM (default: by shared memory alone)."""
    n_tiles = -(-W // TILE)
    r_tiles = sorted({min(R, 1 << i) for i in range(R.bit_length() + 1)})
    best = None
    for tiles in _run_lengths(n_tiles):
        warps = block_warps(n_i, n_n, n_o, tiles)
        if warps < 1:
            continue
        per_sm = (occupancy(tiles) if occupancy is not None else
                  blocks_by_smem(smem_bytes(n_i, n_n, n_o, tiles)))
        for rt in r_tiles:
            key = wave_cost(R, n_tiles, tiles, warps, per_sm * sm_count, rt,
                            staged=True)
            if best is None or key < best[0]:
                best = (key, (tiles, rt))
    if best is None:
        raise ValueError(f"no cube-major run fits {MAX_SMEM_BYTES} B of "
                         f"shared memory beside a wire plane of "
                         f"{n_i + n_n} rows")
    return best[1]


def run_tiles(layout: str, block_words: int | None, R: int, W: int,
              n_i: int, n_n: int, n_o: int, sm_count: int,
              occupancy=None) -> int:
    """Tiles per run (one block's share of the cube) for a variant.

    An explicit ``block_words`` must be a multiple of the 32-word tile or
    cover the whole cube; a cube-major run that does not fit in shared
    memory beside one wire plane raises.  ``None`` takes the sizing rule's
    run: ``tiles_per_block`` (genome-major) or ``cube_defaults``.
    ``occupancy(run_tiles)`` gives the resident blocks an SM of the
    layout's block (default: by shared memory alone)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    n_tiles = -(-W // TILE)
    if block_words is None:
        if layout == "cube_major":
            return cube_defaults(R, W, n_i, n_n, n_o, sm_count,
                                 occupancy)[0]
        per_sm = (occupancy(None) if occupancy is not None else
                  blocks_by_smem(smem_bytes(n_i, n_n, n_o)))
        return tiles_per_block(R, W, sm_count, per_sm,
                               max(1, block_warps(n_i, n_n, n_o)))
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
    # the kernel's instantiations load at most 32 input planes a tile
    if not 1 <= n_i <= 32:
        raise ValueError(f"n_i={n_i} outside 1..32")
    if golden_vals.data_ptr() % 16:
        raise ValueError("golden_vals must be 16-byte aligned (int4 reads)")


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
        takes the sizing rule's (``tiles_per_block``, ``cube_defaults``).
      total_words: the words of the whole cube when ``in_planes`` is a slice
        of it (default W): it fixes the magnitude regime.
    Returns ``RawSums``; the magnitude regime is ``metrics.exact_sum_per_bit
    (32·total_words, n_o)``.  Launches the kernel; raises for tensors not on
    CUDA.
    """
    _check(nodes, outs, in_planes, golden_vals, n_i, n_n, n_o)
    if nodes.device.type != "cuda":
        raise ValueError(f"no cgp_sim kernel for device {nodes.device}")
    dev = nodes.device
    R, W = nodes.shape[0], in_planes.shape[1]
    per_bit = M.exact_sum_per_bit(32 * (total_words or W), n_o)
    with torch.cuda.device(dev):
        geo = geometry(layout, block_words, r_tile, R, W, n_i, n_n, n_o,
                       per_bit)
    tpb, r_tile = geo.run_tiles, geo.r_tile
    n_tiles = -(-W // TILE)
    mag = torch.zeros((R, 3, n_o if per_bit else 1), dtype=torch.int64,
                      device=dev)
    ints = torch.zeros((R, N_INTS), dtype=torch.int32, device=dev)
    wce = torch.zeros((R,), dtype=torch.int32, device=dev)
    pops = torch.zeros((R, n_n), dtype=torch.int32, device=dev)
    fpart = torch.empty((R, n_tiles, 3), dtype=torch.float64, device=dev)
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
    if r_tile:
        CUBE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    if R == 1:
        SINGLE_LAUNCHES += 1
    return RawSums(mag, ints, wce, pops, fpart.sum(dim=1))


def check_division(golden_vals: torch.Tensor, max_ad: int) -> int:
    """The (|d|, g) pairs, |d| in 0..``max_ad`` and g over ``golden_vals``
    (a CUDA int32 tensor, each taken as max(g, 1)), where the kernel's
    division differs from ``__fdiv_rn`` in any bit: 0 proves them equal
    over the pairs a cube of these golden values gives."""
    g = torch.unique(golden_vals).to(torch.int32).contiguous()
    bad = torch.zeros(1, dtype=torch.int64, device=g.device)
    lib = _library()
    with torch.cuda.device(g.device):
        err = lib.cgp_sim_check_division(
            g.data_ptr(), g.numel(), max_ad, bad.data_ptr(),
            torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError("cgp_sim division check failed: "
                           + lib.cgp_sim_error_string(err).decode())
    return int(bad)


def geometry(layout: str, block_words: int | None, r_tile: int | None,
             R: int, W: int, n_i: int, n_n: int, n_o: int,
             per_bit: bool) -> Geometry:
    """The launch of a variant on the current device: its run, group size
    (the sizing rule's where ``None``), grid and occupancy.  Raises where
    the variant does not fit.  Cached: the wrapper asks on every launch."""
    return _geometry(torch.cuda.current_device(), layout, block_words,
                     r_tile, R, W, n_i, n_n, n_o, per_bit)


@functools.lru_cache(maxsize=1024)
def _geometry(index, layout, block_words, r_tile, R, W, n_i, n_n, n_o,
              per_bit) -> Geometry:
    cube = layout == "cube_major"
    sms = _sm_count(index)
    resident = lambda run: occupancy(n_i, n_n, n_o, run or 0,
                                     1 if run else 0, per_bit).blocks_per_sm
    if cube and block_words is None and r_tile is None:
        tpb, r_tile = cube_defaults(R, W, n_i, n_n, n_o, sms, resident)
    else:
        tpb = run_tiles(layout, block_words, R, W, n_i, n_n, n_o, sms,
                        resident)
        if cube and r_tile is None:
            r_tile = cube_defaults(R, W, n_i, n_n, n_o, sms, resident)[1]
    if not cube:
        r_tile = 0     # the launcher's code for one genome per block
    elif r_tile < 1:
        raise ValueError(f"r_tile must be positive, got {r_tile}")
    smem = smem_bytes(n_i, n_n, n_o, tpb if cube else None)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"wire plane of {n_i + n_n} rows needs {smem} B of "
                         f"shared memory > {MAX_SMEM_BYTES}")
    groups = -(-R // r_tile) if cube else R
    if groups > 65535:
        raise ValueError(f"{groups} genome groups exceed the grid")
    return Geometry(tpb, r_tile, -(-(-(-W // TILE)) // tpb) * groups,
                    occupancy(n_i, n_n, n_o, tpb if cube else 0,
                              int(cube), per_bit))


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
