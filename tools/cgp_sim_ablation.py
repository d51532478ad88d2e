#!/usr/bin/env python3
"""What each design point of the cgp_sim kernel is worth, on the card.

  python3 tools/cgp_sim_ablation.py [--variants a,b,...] [--launches N]
                                    [--rounds N] [--against DIR]

Builds ``src/repro_torch/kernels/csrc/cgp_sim.cu`` as shipped and in
variants that each undo one design point (a ``-D`` switch of the source,
one nvcc per variant, started together), plus two timing-only variants;
then, in this process, times each at the main path's shape (R = 256
genomes of 400 nodes over the width-8 multiplier's 2048-word cube) in
both layouts:
CUDA events around each launch, the median of ``--launches`` (at least 9)
with its quartiles.  Every variant but the timing-only ones is checked
against ``ref.cgp_eval_ref`` (integer rows and popcounts exact, float rows
within rtol 1e-6).  Prints one JSON line per variant and layout, then the
card's name and power limit.  ``--against DIR`` also times the kernel of
another checkout (for example the parent commit's, unpacked with ``git
archive``) at default knobs in both layouts, in its own process, in turns
with this checkout's (DIR, this, this, DIR).  Needs one CUDA card and
nvcc; the builds go to the gitignored kernel build directory.  With no
ncu on the card, this is how the kernel's time is split.

Variants:
  shipped        the source as it is
  one_warp       one warp a block (undoes blocks of several warps)
  index_order    gates walked in index order, one at a time (undoes the
                 level-ordered, batched walk)
  batch8         the level-ordered walk in batches of 8 gates, not 4
  popc_modulo    per-gate popcounts by the pass over the plane as before
                 the redesign, modulo the tile's words (undoes the
                 XOR-swizzled pass)
  popc_redux     per-gate popcounts in the walk by redux.sync, a batch's
                 reductions back to back (the other way to drop the pass)
  bit_unpack     each output bit of each input extracted on its own
                 (undoes the register bit transpose)
  mask_rebuild   lane masks rebuilt from the truth table per gate (undoes
                 the mask word staged in the entries)
  wide_entries   32-byte entries holding the four lane masks as words (no
                 byte permutes; twice the entry bytes a gate)
  fdiv           |d|/max(g, 1) by __fdiv_rn, with its range check and slow
                 path (undoes the division's bare fast path)
  old_grid       the shipped kernel on the grid of the rule it replaced
                 (~8 blocks an SM: 13-tile runs, cube-major 8 genomes a
                 block) (undoes the whole-wave sizing rule)
  walk_only      metrics skipped (timing only; its outputs are wrong)
  walk_bare      metrics and popcounts skipped: the walk alone (timing
                 only)
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
WIDTH, NODES, R = 8, 400, 256

# variant -> (-D switches of the source, wrapper constants, knobs by layout)
VARIANTS = {
    "shipped": ({}, {}, {}),
    "one_warp": ({"MAX_WARPS": 1}, {"MAX_WARPS": 1}, {}),
    "index_order": ({"LEVEL_ORDER": 0, "BATCH": 1}, {"BATCH": 1}, {}),
    "batch8": ({"BATCH": 8}, {"BATCH": 8}, {}),
    "popc_modulo": ({"POPC": 3}, {}, {}),
    "popc_redux": ({"POPC": 1}, {}, {}),
    "bit_unpack": ({"UNPACK_TRANSPOSE": 0}, {}, {}),
    "mask_rebuild": ({"STAGED_MASKS": 0}, {}, {}),
    "wide_entries": ({"WIDE_ENTRIES": 1}, {"ENTRY_BYTES": 32}, {}),
    "fdiv": ({"FAST_DIV": 0}, {}, {}),
    "old_grid": ({}, {}, {"genome_major": dict(block_words=13 * 32),
                          "cube_major": dict(block_words=13 * 32,
                                             r_tile=8)}),
    "walk_only": ({"METRICS": 0}, {}, {}),
    "walk_bare": ({"METRICS": 0, "POPC": 0}, {}, {}),
}
UNCHECKED = ("walk_only", "walk_bare")


def build(name: str) -> tuple[str, Path, str]:
    """nvcc of the source with the variant's switches: (name, library,
    ptxas's report)."""
    from repro_torch.kernels import cgp_sim, nvcc
    out = nvcc.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"cgp_sim_{name}.so"
    defs = [f"-D{k}={v}" for k, v in VARIANTS[name][0].items()]
    proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, *defs, "-o",
                           str(so), str(cgp_sim.SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return name, so, proc.stdout + proc.stderr


def quartiles(xs):
    xs = sorted(xs)
    at = lambda q: xs[min(len(xs) - 1, round(q * (len(xs) - 1)))]
    return at(0.25), at(0.5), at(0.75)


def measure(name, lib_path, problem, want, launches):
    """One variant in both layouts: per-launch CUDA-event times and the
    check against the plain version."""
    import torch
    from repro_torch.core import metrics as M
    from repro_torch.kernels import cgp_sim, ops
    _, consts, knobs = VARIANTS[name]
    saved = {k: getattr(cgp_sim, k) for k in consts}
    for k, v in consts.items():
        setattr(cgp_sim, k, v)
    cgp_sim._LIB = cgp_sim.load(lib_path)
    cgp_sim.occupancy.cache_clear()
    cgp_sim._geometry.cache_clear()
    spec, planes, gvals, g = problem
    rows = []
    try:
        for layout in cgp_sim.LAYOUTS:
            kw = dict(n_i=spec.n_i, n_n=spec.n_n, n_o=spec.n_o,
                      gauss_sigma=256.0, layout=layout,
                      **knobs.get(layout, {}))
            run = lambda: cgp_sim.cgp_sim_metrics_batched(
                g.nodes, g.outs, planes, gvals, **kw)
            raw = run()
            torch.cuda.synchronize()
            geo = cgp_sim.geometry(layout, kw.get("block_words"),
                                   kw.get("r_tile"), R, planes.shape[1],
                                   spec.n_i, spec.n_n, spec.n_o,
                                   M.exact_sum_per_bit(32 * planes.shape[1],
                                                       spec.n_o))
            checked = name not in UNCHECKED
            bad = []
            if checked:
                got = ops._partials_from_raw(raw, planes.shape[1], spec.n_o)
                for field in got._fields:
                    a, b = getattr(got, field), getattr(want[0], field)
                    if a.dtype.is_floating_point:
                        ok = bool(((a.double() - b.double()).abs()
                                   <= 1e-6 * b.double().abs()).all())
                    else:
                        ok = torch.equal(a.long(), b.long())
                    if not ok:
                        bad.append(field)
                if not torch.equal(raw.pops.float(), want[1]):
                    bad.append("pops")
            for _ in range(3):
                run()
            events = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(launches)]
            torch.cuda.synchronize()
            for a, b in events:
                a.record()
                run()
                b.record()
            torch.cuda.synchronize()
            q1, med, q3 = quartiles([a.elapsed_time(b) for a, b in events])
            occ = geo.occupancy
            rows.append(dict(
                variant=name, layout=layout, ms=med, q1=q1, q3=q3,
                launches=launches, checked=checked,
                correct=(not bad) if checked else None, bad=bad,
                blocks=geo.blocks, run_tiles=geo.run_tiles,
                r_tile=geo.r_tile, warps=occ.warps,
                blocks_per_sm=occ.blocks_per_sm, registers=occ.registers,
                smem=occ.smem))
    finally:
        for k, v in saved.items():
            setattr(cgp_sim, k, v)
    return rows


def time_tree(tree: str, launches: int) -> dict:
    """The cgp_sim kernel of the checkout at ``tree`` at default knobs in
    both layouts (run in a process of its own, which imports that
    checkout's package): per-launch CUDA-event quartiles."""
    sys.path[:0] = [str(Path(tree) / "src"), str(tree)]
    import numpy as np
    import torch
    import chip_smoke
    from repro_torch.kernels import cgp_sim
    gold, spec, planes, gvals, _ = chip_smoke.problem(WIDTH, "mul", NODES,
                                                      "cuda")
    g = chip_smoke.genomes(np.random.default_rng(0), gold, spec, R, "cuda")
    out = {"tree": str(tree)}
    for layout in ("genome_major", "cube_major"):
        run = lambda: cgp_sim.cgp_sim_metrics_batched(
            g.nodes, g.outs, planes, gvals, n_i=spec.n_i, n_n=spec.n_n,
            n_o=spec.n_o, gauss_sigma=256.0, layout=layout)
        for _ in range(3):
            run()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(launches)]
        torch.cuda.synchronize()
        for a, b in events:
            a.record()
            run()
            b.record()
        torch.cuda.synchronize()
        q1, med, q3 = quartiles([a.elapsed_time(b) for a, b in events])
        out[layout] = dict(ms=med, q1=q1, q3=q3)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    ap.add_argument("--launches", type=int, default=15,
                    help="timed launches a variant and layout (>= 9)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="measure every variant this many times, the order "
                         "reversed each round (for the spread)")
    ap.add_argument("--against", metavar="DIR",
                    help="also time the kernel of the checkout at DIR")
    ap.add_argument("--time-tree", metavar="DIR",
                    help=argparse.SUPPRESS)   # one checkout's process
    args = ap.parse_args()
    if args.time_tree:
        print(json.dumps(time_tree(args.time_tree, args.launches)),
              flush=True)
        return 0
    if args.launches < 9:
        ap.error("--launches must be at least 9")
    sys.path.insert(0, str(SRC))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("cgp_sim_ablation: no CUDA device")
        return 2
    import chip_smoke
    from repro_torch.kernels import ref
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:   # one nvcc per variant
        built = {n: (so, log) for n, so, log in pool.map(build, names)}
    print(f"[build] {len(names)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for n, (_, log) in built.items():
        regs = sorted({int(x.split("Used ")[1].split()[0])
                       for x in log.splitlines() if "Used" in x})
        print(f"[build] {n}: registers {regs}", flush=True)
    gold, spec, planes, gvals, _ = chip_smoke.problem(WIDTH, "mul", NODES,
                                                      "cuda")
    g = chip_smoke.genomes(np.random.default_rng(0), gold, spec, R, "cuda")
    want = ref.cgp_eval_ref(g, spec, planes, gvals, 256.0)
    order = [n for r in range(args.rounds)
             for n in (names if r % 2 == 0 else names[::-1])]
    for n in order:
        for row in measure(n, built[n][0], (spec, planes, gvals, g), want,
                           args.launches):
            print(json.dumps(row), flush=True)
    if args.against:
        for tree in (args.against, ROOT, ROOT, args.against):
            proc = subprocess.run(
                [sys.executable, __file__, "--time-tree", str(tree),
                 "--launches", str(args.launches)],
                capture_output=True, text=True, timeout=600)
            lines = [l for l in proc.stdout.splitlines()
                     if l.startswith("{")]
            print(lines[-1] if lines and proc.returncode == 0 else
                  json.dumps({"tree": str(tree),
                              "error": proc.stderr[-2000:]}), flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
