#!/usr/bin/env python3
"""What each design choice of flash_attention's tensor-core body is worth,
on the card.

  python3 tools/flash_attention_ablation.py [--variants a,b,...] [--rounds N]

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is and in
variants that each undo one choice (a text edit of the source, one nvcc
per variant, started together), then in one process per variant: the
bf16 causal launches at (1, 32, 8, 32768, 64), (1, 32, 8, 4096, 160) and
(1, 32, 8, 32768, 160) timed with CUDA events, and the result at those
shapes and at the serve shapes (4, 32, 8, 32, 64) and (2, 32, 8, 32, 160)
held against ``ref.flash_attention_ref`` under ``chip_smoke.py``'s bf16
tolerance (float32 rtol 1e-5 / atol 1e-6 plus one bf16 ulp), with ptxas's
registers, stack and spills of each tensor-core instantiation.  Prints
one JSON line per variant and the card's name and power limit.  Needs
one CUDA card and nvcc; the builds go to the gitignored kernel build
directory.

Variants (the first four change every head dim, the last three D = 160's
alone):
  shipped            the source as it is
  mask_every_tile    the mask runs on every kv tile, not only the edges
  direct_accumulate  P·V accumulates onto the rescaled running output
                     inside the tensor cores (no fresh tile accumulator)
  two_term           P·V from p_hi + p_mid (P cut to 16 significant bits)
  one_term           P·V from p_hi alone (P rounded toward zero to bf16)
  pv_split_96_64     D = 160's P·V in two groups of output columns, 96
                     then 64, each issued, waited on and folded in before
                     the next (one tile accumulator of 48 registers live,
                     not 80), not one group of 160
  pv_split_128_32    the same in groups of 128 + 32 columns
  d160_at_192        D = 160 on an instantiation at 192 (64-column chunks
                     and the 128-byte swizzle, TMA zero-filling columns
                     160-191; P·V in groups of 128 + 64: one group of 192
                     would hold 272 registers), not five 32-column chunks
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
# (B, Hq, Hkv, S, D), bf16, causal: checked, and timed where marked
SHAPES = {"long": ((1, 32, 8, 32768, 64), True),
          "serve": ((4, 32, 8, 32, 64), False),
          "d160": ((1, 32, 8, 4096, 160), True),
          "d160_long": ((1, 32, 8, 32768, 160), True),
          "d160_serve": ((2, 32, 8, 32, 160), False)}
# variants whose plan differs from the shipped one: the tensor-core head
# dims their process plans with
TC_HEAD_DIMS = {"d160_at_192": (16, 32, 64, 128, 192)}


def _wgmma_rs(n: int) -> str:
    """A ``wgmma_rs`` overload for m64n{n}k16 (n / 2 accumulator
    registers), in the source's form."""
    r = n // 2
    regs = ", ".join(f"%{i}" for i in range(r))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(r))
    return (f"__device__ __forceinline__ void wgmma_rs(float (&d)[{r}], "
            f"const uint32_t* a,\n    uint64_t db, int accumulate) {{\n"
            f"  asm volatile(\n"
            f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{r + 5}, 0;\\n"\n'
            f'      "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "\n'
            f'      "{{{regs}}}, "\n'
            f'      "{{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, %{r + 4}, '
            f'p, 1, 1, 1;\\n}}\\n"\n'
            f"      : {outs}\n"
            f'      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),\n'
            f'        "r"(accumulate));\n}}\n\n')


# P·V of one kv tile in two groups of output columns, NA then D - NA (NA
# a multiple of the chunk: wgmma cannot start a B operand inside a swizzle
# span), the second group's accumulator in the first's registers
PV_GROUPS = """
template <int D, int NA>
__device__ __forceinline__ void pv_groups(float (&acc)[D / 2],
                                          float (&pv)[NA / 2],
                                          const float (&alpha)[2],
                                          uint32_t (&p_hi)[16],
                                          uint32_t (&p_mid)[16],
                                          uint32_t (&p_lo)[16],
                                          uint64_t v_desc) {
  using G = Geo<D>;
  constexpr int NB = D - NA;
  static_assert(NA % G::CH == 0 && NB <= NA, "groups start on a chunk");
  float (&pb)[NB / 2] = reinterpret_cast<float (&)[NB / 2]>(pv);
  wg_fence();
  fence_regs(pv);
#pragma unroll
  for (int kk = 0; kk < KV_ROWS / 16; ++kk) {
    const uint64_t dv = v_desc + ((kk * 16 * G::ROWB) >> 4);
    wgmma_rs(pv, p_lo + 4 * kk, dv, kk > 0);
    wgmma_rs(pv, p_mid + 4 * kk, dv, 1);
    wgmma_rs(pv, p_hi + 4 * kk, dv, 1);
  }
  wg_commit();
  wg_wait();
  fence_regs(pv);
#pragma unroll
  for (int i = 0; i < NA / 2; ++i)
    acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
  wg_fence();
  fence_regs(pb);
#pragma unroll
  for (int kk = 0; kk < KV_ROWS / 16; ++kk) {
    const uint64_t dv = v_desc + ((NA / G::CH * G::KV_CHUNK +
                                   kk * 16 * G::ROWB) >> 4);
    wgmma_rs(pb, p_lo + 4 * kk, dv, kk > 0);
    wgmma_rs(pb, p_mid + 4 * kk, dv, 1);
    wgmma_rs(pb, p_hi + 4 * kk, dv, 1);
  }
  wg_commit();
  wg_wait();
  fence_regs(pb);
  fence_regs(p_hi);
  fence_regs(p_mid);
  fence_regs(p_lo);
#pragma unroll
  for (int i = 0; i < NB / 2; ++i)
    acc[NA / 2 + i] = fmaf(acc[NA / 2 + i], alpha[(i >> 1) & 1], pb[i]);
}

"""
KERNEL = ("template <int D>\n"
          "__global__ void __launch_bounds__(BLOCK_THREADS, 1)")
PV_STEP = """      issue_pv<D>(pv, p_hi, p_mid, p_lo, v_desc + s * STAGE16);
      wg_wait();
      fold(acc, pv, alpha, p_hi, p_mid, p_lo);
"""
N128 = "// O[64 x 128] (+)= A·B"


def _split(dp: int, na: int) -> list[tuple[str, str]]:
    """Edits that run P·V at head dim ``dp`` in groups of ``na`` and
    ``dp - na`` columns (``pv_groups``), pv sized to the first."""
    return [
        (KERNEL, PV_GROUPS + KERNEL),
        ("    float acc[D / 2], pv[D / 2], sc[32], alpha[2];",
         f"    constexpr int PV = D == {dp} ? {na} : D;\n"
         "    float acc[D / 2], pv[PV / 2], sc[32], alpha[2];"),
        (PV_STEP, "      if constexpr (PV < D) {\n"
                  "        pv_groups<D, PV>(acc, pv, alpha, p_hi, p_mid, "
                  "p_lo, v_desc + s * STAGE16);\n"
                  "      } else {\n" + PV_STEP + "      }\n")]


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
        "pv_split_96_64": [(N128, _wgmma_rs(96) + N128)] + _split(160, 96),
        "pv_split_128_32": _split(160, 128),
        "d160_at_192": _split(192, 128) + [
            ("case 160: return launch_tc<160>",
             "case 192: return launch_tc<192>"),
            ("case 160: return tc::Geo<160>::SMEM;",
             "case 192: return tc::Geo<192>::SMEM;")],
    }


def variant_source(name: str, text: str) -> str:
    for old, new in _edits()[name]:
        if old not in text:
            raise ValueError(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def build(name: str, text: str) -> tuple[str, Path | str]:
    """Compile one variant; its ptxas report goes beside it (.log).
    Returns the library, or nvcc's errors where it failed."""
    from repro_torch.kernels import nvcc
    out = nvcc.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"flash_attention_{name}.cu", out / f"{name}.so"
    cu.write_text(text)
    proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        return name, "nvcc failed:\n" + (proc.stdout + proc.stderr)[-6000:]
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return name, so


def _ulp(x):
    import torch
    mag = x.abs().float().clamp_min(torch.finfo(torch.float32).tiny)
    return (mag.view(torch.int32) & 0x7F800000).view(torch.float32) * 2.0 ** -7


def measure(name: str, so: str) -> dict:
    """One variant, in this process: its ptxas resources, the checks and
    the times of SHAPES."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import nvcc, ref
    FA.build = lambda: nvcc.BuildInfo(Path(so), 0.0, "")
    FA.TC_HEAD_DIMS = TC_HEAD_DIMS.get(name, FA.TC_HEAD_DIMS)
    out = {"variant": name, "resources": {
        D: {k: r.get(k) for k in ("registers", "stack", "spill_stores",
                                  "spill_loads")}
        for D, r in FA.tc_resources(
            Path(so).with_suffix(".log").read_text()).items()}}
    for tag, (shape, timed) in SHAPES.items():
        try:
            _measure_shape(FA, ref, out, tag, shape, timed)
        except Exception as e:   # a failed launch: record it, go on
            out[f"{tag}_error"] = repr(e)[:500]
    return out


def _measure_shape(FA, ref, out, tag, shape, timed) -> None:
    """One shape of ``measure``: its check into ``out`` and, if
    ``timed``, three runs of three launches between CUDA events."""
    import torch
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
    out[f"{tag}_head_dim"] = FA.plan(q.shape, k.shape, q.dtype,
                                     q.stride(), k.stride(),
                                     v.stride()).head_dim
    if timed:
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
        out[f"{tag}_ms"] = runs


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
    for n in [n for n in names if isinstance(libs[n], str)]:
        print(json.dumps({"variant": n, "error": libs.pop(n)}), flush=True)
    names = [n for n in names if n in libs]
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
