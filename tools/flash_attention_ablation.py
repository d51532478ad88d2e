#!/usr/bin/env python3
"""What each design choice of flash_attention's tensor-core body is worth,
on the card.

  python3 tools/flash_attention_ablation.py [--variants a,b,...] [--rounds N]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is and in
variants that each undo one choice (a text edit of the source, one nvcc
per variant, started together), then in one process per variant: the
bf16 causal launch at (1, 32, 8, 32768, 64) timed with CUDA events, and
the result at that shape and at the serve shape (4, 32, 8, 32, 64) held
against ``ref.flash_attention_ref`` under ``chip_smoke.py``'s bf16
tolerance (float32 rtol 1e-5 / atol 1e-6 plus one bf16 ulp).  Prints one
JSON line per variant and the card's name and power limit.  Needs one
CUDA card and nvcc; the builds go to the gitignored kernel build
directory.

Variants:
  shipped            the source as it is
  mask_every_tile    the mask runs on every kv tile, not only the edges
  direct_accumulate  P·V accumulates onto the rescaled running output
                     inside the tensor cores (no fresh tile accumulator)
  two_term           P·V from p_hi + p_mid (P cut to 16 significant bits)
  one_term           P·V from p_hi alone (P rounded toward zero to bf16)
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
LONG, SERVE = (1, 32, 8, 32768, 64), (4, 32, 8, 32, 64)


def _edits() -> dict[str, list[tuple[str, str]]]:
    """variant -> (old, new) replacements of the source, each required to
    apply."""
    rescale = ("#pragma unroll\n      for (int i = 0; i < D / 2; ++i) "
               "acc[i] *= alpha[(i >> 1) & 1];\n")
    return {
        "shipped": [],
        "mask_every_tile": [
            ("if ((causal && k_end - 1 > row0) || k_end > Skv)", "if (true)")],
        "direct_accumulate": [
            ("wgmma_rs(pv, p_lo + 4 * kk, dv, kk > 0);",
             "wgmma_rs(pv, p_lo + 4 * kk, dv, 1);"),
            ("acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);",
             "(void)pv[i];"),
            ("      issue_pv<D>(pv, p_hi, p_mid, p_lo,",
             rescale + "      issue_pv<D>(acc, p_hi, p_mid, p_lo,")],
        "two_term": [("    wgmma_rs(pv, p_lo + 4 * kk, dv, kk > 0);\n", ""),
                     ("wgmma_rs(pv, p_mid + 4 * kk, dv, 1);",
                      "wgmma_rs(pv, p_mid + 4 * kk, dv, kk > 0);")],
        "one_term": [("    wgmma_rs(pv, p_mid + 4 * kk, dv, 1);\n", ""),
                     ("    wgmma_rs(pv, p_lo + 4 * kk, dv, kk > 0);\n", ""),
                     ("wgmma_rs(pv, p_hi + 4 * kk, dv, 1);",
                      "wgmma_rs(pv, p_hi + 4 * kk, dv, kk > 0);")],
    }


def variant_source(name: str, text: str) -> str:
    for old, new in _edits()[name]:
        if old not in text:
            raise ValueError(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build(name: str, text: str) -> tuple[str, Path]:
    from repro_torch.kernels import nvcc
    out = nvcc.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"flash_attention_{name}.cu", out / f"{name}.so"
    cu.write_text(text)
    proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return name, so


def _ulp(x):
    import torch
    mag = x.abs().float().clamp_min(torch.finfo(torch.float32).tiny)
    return (mag.view(torch.int32) & 0x7F800000).view(torch.float32) * 2.0 ** -7


def measure(name: str, so: str) -> dict:
    """One variant, in this process: the 32k time and both checks."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import nvcc, ref
    FA.build = lambda: nvcc.BuildInfo(Path(so), 0.0, "")
    out = {"variant": name}
    for tag, shape in (("long", LONG), ("serve", SERVE)):
        B, Hq, Hkv, S, D = shape
        gen = torch.Generator(device="cuda").manual_seed(1)
        q, k, v = (torch.randn((B, h, S, D), generator=gen, device="cuda")
                   .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        got = FA.flash_attention(q, k, v, causal=True).float()
        want = ref.flash_attention_ref(q, k, v, True).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        tol = 1e-6 + 1e-5 * want.abs() + _ulp(torch.maximum(got.abs(),
                                                            want.abs()))
        out[f"{tag}_bad"] = int((err > tol).sum())
        out[f"{tag}_worst_x_tol"] = float((err / tol).max())
        if tag == "long":
            fn = lambda: FA.flash_attention(q, k, v, causal=True)
            fn()
            torch.cuda.synchronize()
            runs = []
            for _ in range(3):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(3):
                    fn()
                b.record()
                torch.cuda.synchronize()
                runs.append(a.elapsed_time(b) / 3)
            out["long_ms"] = runs
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(_edits()),
                    help="comma-separated variants (default: all)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="measure every variant this many times, the order "
                         "reversed each round (for the spread)")
    ap.add_argument("--measure", nargs=2, metavar=("NAME", "LIB"),
                    help=argparse.SUPPRESS)   # one variant's process
    args = ap.parse_args()
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("flash_attention_ablation: no CUDA device")
        return 2
    if args.measure:
        print(json.dumps(measure(*args.measure)), flush=True)
        return 0
    from repro_torch.kernels import flash_attention as FA
    text = FA.SOURCE.read_text()
    names = args.variants.split(",")
    sources = {n: variant_source(n, text) for n in names}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(pool.map(lambda n: build(n, sources[n]), names))
    print(f"[build] {len(names)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    order = [n for r in range(args.rounds)
             for n in (names if r % 2 == 0 else names[::-1])]
    for n in order:
        proc = subprocess.run(
            [sys.executable, __file__, "--measure", n, str(libs[n])],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": str(SRC)})
        lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
        print(lines[-1] if lines and proc.returncode == 0 else json.dumps(
            {"variant": n, "error": proc.stderr[-2000:]}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
