#!/usr/bin/env python3
"""What each design point of the lut_matmul kernel is worth, on the card.

  python3 tools/lut_matmul_ablation.py [--variants a,b,...] [--launches N]
                                       [--rounds N] [--against DIR]

Builds ``src/repro_torch/kernels/csrc/lut_matmul.cu`` as shipped and in
variants that each undo one design point (a ``-D`` switch of the source,
or plans restricted to one-block clusters; one nvcc per source build,
started together), plus two timing-only variants; then, in this process,
times each at the serve path's 8 shapes (llama3.2-1b's projections at
M = 128, prefill, and M = 4, decode) under two operand distributions:

  uniform     uniformly random bytes (the numbers ``chip_smoke.py`` phase 7
              has reported since the kernel was ported);
  serve-like  a seeded llama3.2-1b layer's weights and Gaussian
              activations, each quantized per tensor by
              ``quant.quantize_u8`` as ``approx_matmul`` does (bytes bunch
              near the zero point, so lookups repeat more).

Each time is the kernel's device time from a torch.profiler trace, the
median of ``--launches`` launches (at least 9) with its quartiles, plus
the zero fill a launch needs where its K slices add into C atomically
(a memset, or another checkout's fill kernel).  Every variant but the
timing-only ones is checked bit for bit against ``ref.lut_matmul_ref`` at
every timed shape and at ragged ones.  Prints one JSON line per variant,
distribution and shape, the shipped build's instructions per product in
its products loop (``cuobjdump -sass``), then the card's name and power
limit.  ``--against DIR`` also times the kernel of another checkout (for
example the parent commit's, unpacked with ``git archive``) at the same
shapes and operands, in its own process, in turns with this checkout's
(DIR, this, this, DIR).  Needs one CUDA card and nvcc; the
builds go to the gitignored kernel build directory.  With no ncu on the
card, this is how the kernel's time is split.

Variants:
  shipped          the source and plan as they are
  no_slab          products read straight from the table, one table row a
                   warp a lookup, pre-shifted row and entry offsets (undoes
                   the slab)
  no_pipeline      each chunk loaded, then waited for, then used (undoes
                   the cp.async ring)
  atomics_split    clusters of one block: every K slice adds into a zeroed
                   C atomically (undoes the split in distributed shared
                   memory)
  no_table         slab rows read at a constant index (timing only: the
                   cost of the reads' bank conflicts)
  staging_only     the table and chunks staged, nothing computed (timing
                   only)
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
DISTS = ("uniform", "serve-like")
BK = 8

# variant -> (-D switches of the source, plans of one-block clusters only)
VARIANTS = {
    "shipped": ({}, False),
    "no_slab": ({"SLAB": 0}, False),
    "no_pipeline": ({"PIPELINE": 0}, False),
    "atomics_split": ({}, True),
    "no_table": ({"NO_TABLE": 1}, False),
    "staging_only": ({"STAGING_ONLY": 1}, False),
}
UNCHECKED = ("no_table", "staging_only")


def chip_smoke():
    """This checkout's ``chip_smoke.py`` (its operand and timing helpers),
    whichever checkout's ``repro_torch`` is on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(defs: dict) -> tuple[Path, str]:
    """nvcc of the source with ``defs``: (library, ptxas's report)."""
    from repro_torch.kernels import lut_matmul, nvcc
    out = nvcc.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    tag = "_".join(f"{k}{v}" for k, v in sorted(defs.items())) or "shipped"
    so = out / f"lut_matmul_{tag}.so"
    proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS,
                           *[f"-D{k}={v}" for k, v in defs.items()], "-o",
                           str(so), str(lut_matmul.SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with {defs}:\n{proc.stderr}")
    return so, proc.stdout + proc.stderr


def quartiles(xs):
    xs = sorted(xs)
    at = lambda q: xs[min(len(xs) - 1, round(q * (len(xs) - 1)))]
    return at(0.25), at(0.5), at(0.75)


def device_ms(fn, launches: int) -> tuple[list[float], float]:
    """Per-launch device ms of the lut_matmul kernel, and the mean device
    ms a launch spends zeroing C, from a torch.profiler trace.  The trace
    may drop a few kernel events (seen on the card); the medians are taken
    over the ones it holds, at least two thirds of the launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    cuda = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    kernel = [e.time_range.elapsed_us() / 1e3 for e in cuda
              if "lut_matmul_kernel" in e.name]
    fill = [e.time_range.elapsed_us() / 1e3 for e in cuda
            if "emset" in e.name or "Fill" in e.name]
    if 3 * len(kernel) < 2 * launches:
        raise RuntimeError(f"the trace holds {len(kernel)} lut_matmul "
                           f"kernels for {launches} launches")
    return kernel, sum(fill) / len(fill) if fill else 0.0


def shapes(cs):
    return [(M, k, n) for M in (cs.SERVE_SLOTS * cs.SERVE_PROMPT,
                                cs.SERVE_SLOTS) for k, n in cs.SERVE_KN]


def operands(cs, dist, M, k, n, device="cuda"):
    import torch
    if dist == "serve-like":
        return cs.serve_operands(device, M, k, n)
    rng = np.random.default_rng(M * 7 + k + n)
    return tuple(torch.as_tensor(rng.integers(0, 256, s, dtype=np.uint8),
                                 device=device) for s in ((M, k), (k, n)))


def table(device="cuda"):
    """A table with LUT[0, 0] != 0 and entries up to 65535 (the kernel's
    time does not depend on the entries)."""
    import torch
    rng = np.random.default_rng(5)
    exact = np.arange(256)[:, None] * np.arange(256)[None, :]
    lut = np.clip(exact + rng.integers(-300, 301, exact.shape), 0, 65535)
    lut[0, 0] = 9
    return torch.as_tensor(lut.astype(np.int32), device=device)


def measure(name, lib_path, cs, launches):
    """One variant: per-launch device times at every shape and
    distribution, and the check against the plain version."""
    import torch
    from repro_torch.kernels import lut_matmul as K
    from repro_torch.kernels import ref
    K._LIB = K.load(lib_path)
    slots = K.cluster_slots(0)
    if VARIANTS[name][1]:
        slots = tuple(s for s in slots if s[0] == 1)
    plan = lambda M, k, n: K.plan(M, n, k, K._sm_count(0), slots)
    lut = table()
    staged = K.stage_table(lut)
    checked = name not in UNCHECKED
    rows = []
    if checked:
        for M, k, n in cs.LUT_RAGGED:
            a, b = operands(cs, "uniform", M, k, n)
            if not torch.equal(K.launch(a, b, staged, plan(M, k, n)),
                               ref.lut_matmul_ref(a, b, lut)):
                raise AssertionError(f"{name} ({M}, {k}, {n}) != plain")
    for dist in DISTS:
        for M, k, n in shapes(cs):
            a, b = operands(cs, dist, M, k, n)
            p = plan(M, k, n)
            run = lambda: K.launch(a, b, staged, p)
            correct = (torch.equal(run(), ref.lut_matmul_ref(a, b, lut))
                       if checked else None)
            ts, fill = device_ms(run, launches)
            q1, med, q3 = quartiles(ts)
            bound = cs.lut_bound_ms(M, k, n)
            rows.append(dict(
                variant=name, dist=dist, shape=[M, k, n], ms=med, q1=q1,
                q3=q3, fill_ms=fill, launches=len(ts), checked=checked,
                correct=correct, bound_ms=bound[0],
                bound_ms_gather=bound[2]["gather"],
                plan=dict(tile=[p.bm, p.bn], splits=p.splits, cs=p.cs,
                          groups=p.groups, grid=p.grid)))
    return rows


def sweep_plans(cs, launches, per_shape=24):
    """The shipped build under the ``per_shape`` candidate plans of least
    modelled time of each serve shape (uniform bytes): per-launch device
    time medians beside the model's clocks, to fit the planning model."""
    from repro_torch.kernels import lut_matmul as K
    lut = table()
    staged = K.stage_table(lut)
    for M, k, n in shapes(cs):
        a, b = operands(cs, "uniform", M, k, n)
        found = sorted(K.candidates(M, n, k, K._sm_count(0),
                                    K.cluster_slots(0)), key=lambda x: x[0])
        for clocks, p in found[:per_shape]:
            ts, fill = device_ms(lambda: K.launch(a, b, staged, p), launches)
            print(json.dumps(dict(
                shape=[M, k, n], clocks=clocks, ms=quartiles(ts)[1],
                fill_ms=fill, bn=p.bn, cs=p.cs, groups=p.groups,
                slice_chunks=p.slice(0)[1], grid=p.grid)), flush=True)


def sass_loop(lib_path: Path) -> dict:
    """Per instantiation of the kernel in the built library (``cuobjdump
    -sass``): the opcodes of the stretch between two block barriers that
    holds the most 8- and 16-byte shared loads -- one chunk's products
    (8 · BM · TN a thread) and the next chunk's copies -- and from them the
    integer and shared-memory instructions per product."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, check=True).stdout
    funcs, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            funcs[fn] = [[]]
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      line)
        if fn and m:
            op = m.group(1)
            if op.startswith("BAR.SYNC"):
                funcs[fn].append([])
            else:
                funcs[fn][-1].append(op)
    result = {}
    for fn, segments in funcs.items():
        m = re.search(r"kernelILi(\d+)ELi(\d+)E", fn)
        if not m:
            continue
        bm, tn = int(m.group(1)), int(m.group(2))
        seg = max(segments, key=lambda ops: sum(
            op.startswith(("LDS.64", "LDS.128")) for op in ops))
        mix = collections.Counter(seg)
        fma = sum(v for k, v in mix.items() if k.startswith("IMAD"))
        alu = sum(v for k, v in mix.items() if k.split(".")[0] in (
            "IADD3", "LEA", "LOP3", "SHF", "PRMT", "VIADD", "SEL", "ISETP",
            "IABS", "VIMNMX"))
        lds = sum(v for k, v in mix.items() if k.startswith("LDS"))
        products = BK * bm * tn
        result[f"{bm}x{256 * tn}"] = dict(
            products=products, alu_per_product=alu / products,
            imad_per_product=fma / products,
            lds_per_product=lds / products, instructions=len(seg),
            mix=dict(mix.most_common()))
    return result


def time_tree(tree: str, launches: int) -> dict:
    """The lut_matmul kernel of the checkout at ``tree`` (in a process of
    its own, which imports that checkout's package) at the serve shapes
    and both distributions: per-launch device-time quartiles."""
    sys.path[:0] = [str(Path(tree) / "src")]
    from repro_torch.kernels import lut_matmul as K
    cs = chip_smoke()
    lut = table()
    staged = K.stage_table(lut)
    out = {"tree": str(tree)}
    for dist in DISTS:
        for M, k, n in shapes(cs):
            a, b = operands(cs, dist, M, k, n)
            ts, fill = device_ms(lambda: K.lut_matmul(a, b, staged),
                                 launches)
            q1, med, q3 = quartiles(ts)
            out[f"{dist} {M}x{k}x{n}"] = dict(ms=med, q1=q1, q3=q3,
                                               fill_ms=fill)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    ap.add_argument("--launches", type=int, default=15,
                    help="timed launches a variant and shape (>= 9)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="measure every variant this many times, the order "
                         "reversed each round (for the spread)")
    ap.add_argument("--against", metavar="DIR",
                    help="also time the kernel of the checkout at DIR")
    ap.add_argument("--sweep-plans", action="store_true",
                    help="also time the shipped build under every "
                         "candidate plan of each serve shape")
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
    import torch
    if not torch.cuda.is_available():
        print("lut_matmul_ablation: no CUDA device")
        return 2
    cs = chip_smoke()
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    sources = {json.dumps(VARIANTS[n][0], sort_keys=True) for n in names}
    if args.sweep_plans:
        sources.add(json.dumps({}, sort_keys=True))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:   # one nvcc per source
        built = dict(zip(sources, pool.map(lambda d: build(json.loads(d)),
                                           sources)))
    print(f"[build] {len(sources)} sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for n in names:
        log = built[json.dumps(VARIANTS[n][0], sort_keys=True)][1]
        regs = sorted({int(x.split("Used ")[1].split()[0])
                       for x in log.splitlines() if "Used" in x})
        spills = sorted({x.strip() for x in log.splitlines()
                         if "spill" in x and " 0 bytes spill" not in x})
        print(f"[build] {n}: registers {regs}; spills {spills or 'none'}",
              flush=True)
    if "shipped" in names:
        lib = built[json.dumps({}, sort_keys=True)][0]
        print(json.dumps({"sass_loop": sass_loop(lib)}), flush=True)
    order = [n for r in range(args.rounds)
             for n in (names if r % 2 == 0 else names[::-1])]
    bad = []
    for n in order:
        for row in measure(n, built[json.dumps(VARIANTS[n][0],
                                               sort_keys=True)][0], cs,
                           args.launches):
            print(json.dumps(row), flush=True)
            if row["correct"] is False:
                bad.append((n, row["dist"], row["shape"]))
    if args.sweep_plans:
        from repro_torch.kernels import lut_matmul as K
        K._LIB = K.load(built[json.dumps({}, sort_keys=True)][0])
        sweep_plans(cs, args.launches)
    if args.against:
        for tree in (args.against, ROOT, ROOT, args.against):
            proc = subprocess.run(
                [sys.executable, __file__, "--time-tree", str(tree),
                 "--launches", str(args.launches)],
                capture_output=True, text=True, timeout=900)
            lines = [l for l in proc.stdout.splitlines()
                     if l.startswith("{")]
            print(lines[-1] if lines and proc.returncode == 0 else
                  json.dumps({"tree": str(tree),
                              "error": proc.stderr[-2000:]}), flush=True)
    print(cs.card_line())
    if bad:
        print(f"lut_matmul_ablation: kernel != plain for {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
