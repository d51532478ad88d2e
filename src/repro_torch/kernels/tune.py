"""Kernel-layout tuning: which ``cgp_sim`` variant ``layout="auto"`` runs.

The port of ``repro/kernels/tune.py``.  The fused evaluation kernel has
execution knobs (``kernels.cgp_sim``'s module docstring says what each means
on the GPU):

  * ``layout`` — ``"genome_major"`` (one block per run of cube tiles and
    genome, the cube read from device memory) or ``"cube_major"`` (the run
    staged once in shared memory, a group of genomes walked over it);
  * ``block_words`` — the cube words one block covers: the run a cube-major
    block keeps resident in shared memory.  ``None`` is the kernel's run
    for occupancy (``cgp_sim.tiles_per_block``);
  * ``r_tile`` — the genomes that share one resident run in cube-major
    (``None``: the sizing rule's, ``cgp_sim.cube_defaults``); 1 in
    genome-major, where it has no meaning.

Which combination is fastest depends on the problem shape and the card,
so this module owns the decision:

  * ``KernelVariant`` — one (layout, block_words, r_tile) point;
    ``default_variants`` enumerates both layouts over the GPU's candidate
    runs, and cube-major over its group sizes.
  * ``autotune`` — times every variant on a synthetic population of random
    genomes with the real kernel on the card (CUDA events, or the caller's
    ``time_fn``) and writes the winner into the tuning table.
  * the tuning table — one JSON file, ``entries`` keyed by
    ``w{width}_r{R}_{backend}``.  The backend names the card's architecture
    (``cuda_sm90``), so the entries of one architecture never shadow
    another's, nor a ``cpu`` entry a card's.  Its path is an argument of
    every function here; the default is ``DEFAULT_TABLE``, a file of the
    port's own (never the JAX package's table), and nothing is read from
    the environment.  Each entry names the card it was measured on.
  * ``resolve_variant`` / ``resolve_layout`` — the ``layout="auto"`` path
    of ``ops.cgp_eval_batched``: the exact (width, R, backend) entry, else
    the entry of the same width and backend with the nearest R (log
    distance), else the default (genome-major).

Entries are advisory: every variant computes the same function (integers
exact; float rows equal or within float64 reassociation, see
``kernels.cgp_sim``), so a stale table costs time, never correctness.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from pathlib import Path
from typing import Callable, Sequence

import torch

DEFAULT_LAYOUT = "genome_major"
TABLE_VERSION = 1
DEFAULT_TABLE = Path(__file__).with_name("kernel_layout.json")

# candidate runs (cube words; clipped to the cube, None = the occupancy
# run) and cube-major genomes per block
BLOCK_CANDIDATES = (None, 64, 128, 256, 512)
R_TILE_CANDIDATES = (2, 8, 32)


@dataclasses.dataclass(frozen=True)
class KernelVariant:
    """One point of the kernel's execution space."""
    layout: str = DEFAULT_LAYOUT
    block_words: int | None = None
    r_tile: int | None = 1

    def key(self) -> str:
        bw = "default" if self.block_words is None else self.block_words
        rt = "default" if self.r_tile is None else self.r_tile
        return f"{self.layout}/bw{bw}/rt{rt}"


def table_key(width: int, R: int, backend: str) -> str:
    return f"w{width}_r{R}_{backend}"


def backend_key(device: torch.device | str) -> str:
    """The table's backend tag of ``device``: ``cuda_sm{major}{minor}`` for
    a card, ``cpu`` for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    major, minor = torch.cuda.get_device_capability(device)
    return f"cuda_sm{major}{minor}"


# path -> (stat token, parsed table or None for an unparseable file).  The
# token (mtime_ns, size, inode) catches same-second rewrites, since writes
# go through an atomic rename (a new inode); a parse failure is cached too,
# so a corrupt table is not re-read on every ``resolve_variant`` call.
_TABLE_CACHE: dict[str, tuple[tuple[int, int, int], dict | None]] = {}


def _stat_token(path: str) -> tuple[int, int, int] | None:
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size, st.st_ino)


def load_table(path: str | os.PathLike | None = None) -> dict:
    """The tuning table ({} if absent or invalid), cached by stat token."""
    path = str(path or DEFAULT_TABLE)
    token = _stat_token(path)
    if token is None:
        return {}
    cached = _TABLE_CACHE.get(path)
    if cached is not None and cached[0] == token:
        return cached[1] or {}
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        table = None
    if not isinstance(table, dict) or not isinstance(table.get("entries"),
                                                      dict):
        table = None
    _TABLE_CACHE[path] = (token, table)
    return table or {}


def save_entry(width: int, R: int, backend: str, entry: dict,
               path: str | os.PathLike | None = None) -> dict:
    """Merge one winner entry into the table (atomic rename write)."""
    from repro_torch.checkpoint import store
    path = str(path or DEFAULT_TABLE)
    table = dict(load_table(path)) or {"version": TABLE_VERSION,
                                       "entries": {}}
    entries = dict(table.get("entries", {}))
    entries[table_key(width, R, backend)] = entry
    table["entries"] = entries
    table["version"] = TABLE_VERSION
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    store.atomic_write_json(path, table)
    _TABLE_CACHE.pop(path, None)
    return table


def default_variants(n_words: int,
                     r_tiles: Sequence[int] = R_TILE_CANDIDATES
                     ) -> list[KernelVariant]:
    """Candidates for a cube of ``n_words`` words: genome-major over every
    candidate run (clipped to the cube), and cube-major over every run ×
    group size.  Every cube-major run fits a block's shared memory up to
    600 nodes at width 10."""
    blocks = [None] + sorted({min(b, n_words) for b in BLOCK_CANDIDATES
                              if b is not None})
    return ([KernelVariant("genome_major", bw, 1) for bw in blocks]
            + [KernelVariant("cube_major", bw, rt)
               for bw in blocks for rt in r_tiles])


def resolve_variant(width: int, R: int, backend: str,
                    path: str | os.PathLike | None = None,
                    default: KernelVariant | None = None) -> KernelVariant:
    """The ``layout="auto"`` resolution: exact → nearest R → default.

    Nearest-R matching (log distance, same width and backend) makes a
    sparse table useful: a sweep's chunk × λ population rarely equals a
    tuned R, but the winner is stable across nearby R."""
    entries = load_table(path).get("entries", {})
    hit = entries.get(table_key(width, R, backend))
    if hit is None:
        prefix, suffix = f"w{width}_r", f"_{backend}"
        best = None
        for key, entry in entries.items():
            if not (key.startswith(prefix) and key.endswith(suffix)):
                continue
            try:
                r_ent = int(key[len(prefix):-len(suffix)])
            except ValueError:
                continue
            dist = abs(math.log(max(r_ent, 1)) - math.log(max(R, 1)))
            if best is None or dist < best[0]:
                best = (dist, entry)
        hit = best[1] if best is not None else None
    if not isinstance(hit, dict):
        return default if default is not None else KernelVariant()
    bw = hit.get("block_words")
    return KernelVariant(layout=hit.get("layout", DEFAULT_LAYOUT),
                         block_words=None if bw is None else int(bw),
                         r_tile=int(hit.get("r_tile", 1)))


def resolve_layout(width: int, R: int, backend: str,
                   path: str | os.PathLike | None = None) -> str:
    return resolve_variant(width, R, backend, path).layout


def _measure(fn: Callable[[], object], reps: int) -> float:
    """Seconds per call on the card: CUDA events around ``reps`` calls,
    after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / reps


def autotune(width: int, R: int, *, kind: str = "mul", n_n: int = 400,
             gauss_sigma: float = 256.0, reps: int = 20,
             variants: Sequence[KernelVariant] | None = None,
             device: torch.device | str = "cuda",
             path: str | os.PathLike | None = None,
             time_fn: Callable[[Callable[[], object], int], float] | None
             = None) -> dict:
    """Time every variant on R random genomes (``random_genome`` of
    ``PRNGKey(0)``'s split, as the reference draws them) and write the
    winner for (width, R, the card's backend) into the table.

    ``time_fn(fn, reps) -> seconds`` replaces the CUDA-event timer.
    Returns the written entry, with every variant's time."""
    from repro_torch import random as RNG
    from repro_torch.core import golden as G
    from repro_torch.core import simulate as S
    from repro_torch.core.genome import CGPSpec, random_genome
    from repro_torch.kernels import cgp_sim

    device = torch.device(device)
    backend = backend_key(device)
    spec = CGPSpec(n_i=2 * width, n_o=2 * width, n_n=n_n)
    planes = torch.tensor(S.input_planes_np(spec.n_i), device=device)
    gvals = torch.tensor(G.golden_values(width, kind), device=device)
    genomes = random_genome(RNG.split(RNG.PRNGKey(0, device), R), spec)
    if variants is None:
        variants = default_variants(planes.shape[1])
    time_fn = time_fn or _measure

    timings: dict[str, float] = {}
    for v in variants:
        def dispatch(v=v):
            return cgp_sim.cgp_sim_metrics_batched(
                genomes.nodes, genomes.outs, planes, gvals, n_i=spec.n_i,
                n_n=spec.n_n, n_o=spec.n_o, gauss_sigma=gauss_sigma,
                layout=v.layout, block_words=v.block_words, r_tile=v.r_tile)
        timings[v.key()] = time_fn(dispatch, reps)

    winner = min(variants, key=lambda v: timings[v.key()])
    entry = {
        "layout": winner.layout,
        "block_words": winner.block_words,
        "r_tile": winner.r_tile,
        "width": width, "R": R, "backend": backend,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else device.type),
        "n_n": n_n, "kind": kind, "reps": reps,
        "seconds": timings,
    }
    save_entry(width, R, backend, entry, path)
    return entry
