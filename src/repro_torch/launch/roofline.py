"""Roofline of the port on the H100 (``repro/launch/roofline.py``'s
analogue).

Per (arch × shape) on the single-pod mesh, three terms a rank, from the
counts of ``launch/dryrun.py``'s trace of rank 0's step:

    compute    = Σ over aten ops of FLOPs / their dtype's peak (PEAK_FLOPS)
                 + Σ over kernel calls of the call's work-model bound
    memory     = bytes the aten ops read and write / HBM_BYTES_PER_S
    collective = Σ over collectives of output bytes / their group's link
                 rate (NVLINK_BYTES_PER_S or NIC_BYTES_PER_S, ``link``)

The port runs eager, so the memory term is its unfused traffic: every aten
op's inputs read and outputs written once, views and allocations free.
The three hand-written kernels (``kernels/ops.py``'s abstract route) add
their work models' least time (``bound_ms``, ``lut_bound_ms``,
``flash_bound_ms``): the same functions ``chip_smoke.py`` prints each
launch's bound with, so a kernel's work is counted the same way whatever
implements it.

Tracing costs time for every layer, so each cell is traced at 1 and 2
layer periods and the rest calibrated:

    body  = f(2) - f(1)          (one period's contribution)
    base  = f(1) - body          (embed + loss + outside-the-stack work)
    total = base + body·n_periods

which is exact because a model's periods are identical: every period runs
the same ops at the same shapes, so every count is linear in the period
count.  So is a training step's peak memory (its saved activations grow a
period at a time), but not a prefill's or a decode step's: they free each
layer's temporaries before the next layer's, so only the arguments (and a
prefill's outputs, the caches it returns, where its peak lies after them)
grow with depth, and what the step holds above them is the deeper
trace's (``served_memory``).  MODEL_FLOPS = 6·N(active)·tokens (train) or 2·N(active)·tokens is
computed analytically per cell; the ratio MODEL_FLOPS / traced FLOPs shows
recompute (remat), the blocked attention's masked blocks and the
quantization glue.

The peaks are published ones, not measured: NVIDIA's H100 SXM data sheet
(dense, 700 W): 989e12 bf16 / fp16 on the tensor cores, 67e12 float32
outside them (``allow_tf32`` is off, as in ``chip_smoke.py``), 34e12
float64, 3.35e12 B/s of HBM, 80 GB a card, NVLink 900 GB/s a card, 450e9
B/s each way.  Across nodes: one 400 Gb/s NIC a card, the DGX H100 layout
(NVIDIA DGX H100 user guide: eight ConnectX-7 400 Gb/s ports for eight
cards), 50e9 B/s.  A group whose ranks all lie in one block of 8
consecutive ranks (a DGX node) is priced at NVLink, any other at the NIC.
No axis of the production (16, 16) mesh stays inside one node: a "model"
line is 16 consecutive ranks (two nodes) and a "data" line strides by 16;
a head group's consecutive ranks (``ctx.Mesh.subgroup``: phi4-mini's
pairs) do, and are priced at NVLink.
That mesh was a TPU v5e pod's 2-D torus, where every axis rides ICI; on
H100 nodes every production collective crosses the NICs.

  PYTHONPATH=src python -m repro_torch.launch.roofline --arch llama3_2_1b \
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.roofline --all \
      --out experiments/roofline_h100.csv

Writes the CSV and ``<out>_notes.json`` (each row with the dominant
term's remedy).  ``--device`` (default ``cuda``, which needs a card) is
the device of the fake tensors traced; ``cpu`` gives the same counts.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os

from repro_torch.configs import base as B
from repro_torch.device import resolve_device
from repro_torch.kernels.cgp_sim import N_INTS
from repro_torch.launch.mesh import make_production_mesh

# ------------------------------ the card ------------------------------------

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float64": 34e12}
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9
NVLINK_BYTES_PER_S = 450e9
NIC_BYTES_PER_S = 50e9
NODE_RANKS = 8

# instructions a second per pipe, from the data sheet's 67 TFLOP/s float32
# (an FMA counts 2) and the CUDA programming guide's per-SM rates for
# compute capability 9.0: 128 float32, 64 int32 add/logic/compare, 16
# popcount/conversion/reciprocal per clock
PIPE_OPS_PER_S = {"float32": 67e12 / 2, "int32": 67e12 / 4,
                  "popc/cvt": 67e12 / 16}
# cgp_sim: the operations the function needs (not what a kernel spends):
# per (genome, gate, word): the gate as 3 LOP3 over its two fan-in words
# and its truth table's lane masks (staged once per gate), the popcount
# and its add;
OPS_PER_GATE_WORD = {"int32": 4, "popc/cvt": 1}
# per (genome, cube input): unpacking by a 32x32 bit transpose of the
# output planes (5 stages x 16 pair swaps x 5 ops per 32 inputs = 12.5);
# diff, |d|, Σ|d| and Σd (the clamped sums follow), d != 0 and its count,
# ACC0 (2), WCE max, the histogram counter (10); a 4-compare search of
# the 9 float32 edges, |d|/max(g, 1) from the golden value's reciprocal
# (shared by all genomes) with 3 fix-up ops, two squares and three adds
# (12); the conversion of |d| (1).
OPS_PER_INPUT = {"int32": 12.5 + 10, "float32": 12, "popc/cvt": 1}
# the wire plane lives in shared memory: per (genome, gate, word) the gate's
# two fan-in loads and its store, at LDS_PER_S lane accesses a second
LDS_PER_GATE_WORD = 3
# shared-memory lane accesses a second: 32 lanes per clock per SM (a
# quarter of the float32 rate), 4 bytes each
LDS_PER_S = 67e12 / 2 / 4
# lut_matmul: per product, its int32 add on the int32 pipe and its uint16
# table entry read from shared memory.  The gather bound -- two int32
# operations and one lane access a product, the least a kernel reading
# every product straight from the table needs -- is given beside it.
LUT_INT32_PER_PRODUCT = 1
LUT_SMEM_BYTES_PER_PRODUCT = 2
LUT_GATHER_BOUND = {"int32": 2, "lds": 1}


def link(ranks) -> str:
    """The link a group's collectives cross: ``"nvlink"`` when all its
    ranks lie in one block of NODE_RANKS consecutive ranks, else
    ``"nic"``."""
    return "nvlink" if len({r // NODE_RANKS for r in ranks}) == 1 else "nic"


LINK_BYTES_PER_S = {"nvlink": NVLINK_BYTES_PER_S, "nic": NIC_BYTES_PER_S}


# --------------------------- kernel work models -----------------------------

def bound_ms(R, n_i, n_n, n_o, W):
    """(ms, what bounds it, per-limit ms) for one ``cgp_sim`` launch of R
    genomes over W words: the larger of each pipe's operations over its
    rate, all operations over the issue rate (4 schedulers x 32 lanes per
    SM, the float32 rate), the wire plane's shared-memory accesses over the
    load/store pipe's rate (``lds``), and the bytes (inputs read once,
    outputs written once) over the HBM rate."""
    gate_words, inputs = R * n_n * W, R * 32 * W
    ops = {p: gate_words * OPS_PER_GATE_WORD.get(p, 0)
           + inputs * OPS_PER_INPUT.get(p, 0) for p in PIPE_OPS_PER_S}
    limits = {p: n / PIPE_OPS_PER_S[p] * 1e3 for p, n in ops.items()}
    limits["issue"] = sum(ops.values()) / PIPE_OPS_PER_S["float32"] * 1e3
    limits["lds"] = gate_words * LDS_PER_GATE_WORD / LDS_PER_S * 1e3
    in_bytes = 4 * (R * (3 * n_n + n_o) + n_i * W + 32 * W)
    out_bytes = R * (3 * 8 + 4 * N_INTS + 4 + 4 * n_n + 3 * 8)
    limits["bytes"] = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    worst = max(limits, key=limits.get)
    return (limits[worst], "bytes" if worst == "bytes" else "operations",
            limits)


def lut_bound_ms(M, K, N):
    """(ms, what bounds it, per-limit ms) for one LUT contraction: per
    product one int32 add on the int32 pipe and its 2-byte table entry
    from shared memory (LDS_PER_S lane accesses of 4 bytes a second), and
    the bytes (uint8 operands and the uint16 table read once, the int32
    output written once) over the HBM rate; "gather" is the gather bound
    (LUT_GATHER_BOUND), given beside it."""
    products = M * K * N
    limits = {"int32": products * LUT_INT32_PER_PRODUCT
              / PIPE_OPS_PER_S["int32"] * 1e3,
              "smem": products * LUT_SMEM_BYTES_PER_PRODUCT
              / (4 * LDS_PER_S) * 1e3,
              "bytes": (M * K + K * N + 2 * 256 * 256 + 4 * M * N)
              / HBM_BYTES_PER_S * 1e3}
    worst = max(limits, key=limits.get)
    limits["gather"] = max(
        products * LUT_GATHER_BOUND["int32"] / PIPE_OPS_PER_S["int32"],
        products * LUT_GATHER_BOUND["lds"] / LDS_PER_S,
        products * sum(LUT_GATHER_BOUND.values()) / PIPE_OPS_PER_S["float32"],
        limits["bytes"] / 1e3) * 1e3
    return (limits[worst], "bytes" if worst == "bytes" else "operations",
            limits)


def attention_pairs(Sq, Skv, causal=True) -> int:
    """(query, key) pairs one head scores: all of them, or under the causal
    mask (query i sees keys 0..i) those with key <= query."""
    if not causal:
        return Sq * Skv
    n = min(Sq, Skv)
    return n * (n + 1) // 2 + (Sq - n) * Skv


def flash_bound_ms(B, Hq, Hkv, Sq, Skv, D, itemsize, causal=True):
    """(ms, what bounds it): 4·B·Hq·D FLOPs a scored pair
    (``attention_pairs``) at the dense bf16 tensor-core peak, or the q, k,
    v and output bytes (k and v of each of the Hkv kv-heads read once) at
    the HBM rate, whichever is larger."""
    flops = 4 * B * Hq * D * attention_pairs(Sq, Skv, causal)
    nbytes = itemsize * B * D * (2 * Hq * Sq + 2 * Hkv * Skv)
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_bound_ms(call: dict) -> float:
    """The work-model bound of one kernel call as ``dryrun`` records it
    (``{"kernel", "shape", "dtype"}``; ``kernels/ops.py``)."""
    name, s = call["kernel"], call["shape"]
    if name == "cgp_sim":
        return bound_ms(*s)[0]
    if name == "lut_matmul":
        return lut_bound_ms(*s)[0]
    if name == "flash_attention":
        return flash_bound_ms(*s)[0]
    raise ValueError(f"no work model for kernel {name!r}")


# ----------------------------- model FLOPs ----------------------------------

def model_flops(cfg: B.ModelConfig, shape: B.ShapeConfig) -> float:
    """Analytic MODEL_FLOPS = 6·N_active·D (train) / 2·N_active·D (inference)
    where D = processed tokens.  Embedding params excluded (lookup)."""
    n_active = active_params(cfg)
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1  # one decode step
    return 2.0 * n_active * tokens


def active_params(cfg: B.ModelConfig) -> float:
    """Non-embedding parameters touched per token."""
    d, hd = cfg.d_model, cfg.hd
    n = 0.0
    for spec in cfg.period:
        if spec.kind == "ssm":
            s = cfg.ssm
            d_in = s.expand * d
            H = d_in // s.headdim
            n += d * (2 * d_in + 2 * s.n_groups * s.d_state + H)
            n += d_in * d  # out proj
        else:
            n += d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
            n += cfg.n_heads * hd * d
        if spec.has_ffn:
            if spec.moe:
                m = cfg.moe
                n += d * m.n_experts  # router
                n += m.top_k * 3 * d * m.d_ff_expert
            else:
                mult = 3 if cfg.act == "swiglu" else 2
                n += mult * d * cfg.d_ff
    n *= cfg.n_periods
    # lm head matmul participates in compute
    n += d * cfg.vocab * (cfg.n_codebooks if cfg.frontend == "audio" else 1)
    return n


# ------------------------------- analysis -----------------------------------

def _measure(arch_id: str, shape: B.ShapeConfig, n_periods: int, mesh,
             device, cfg: B.ModelConfig | None = None) -> dict:
    """``dryrun.trace_cell`` of the cell cut to ``n_periods`` layer
    periods."""
    from repro_torch.launch import dryrun   # it imports this module
    cfg = cfg or B.get_arch(arch_id).CONFIG
    small = dataclasses.replace(cfg, n_layers=n_periods * len(cfg.period))
    return dryrun.trace_cell(arch_id, shape, mesh, device, small)


def price(rec: dict) -> dict:
    """The three terms (seconds) of a dry-run record's counts."""
    flops = rec["cost_analysis"]["flops_by_dtype"]
    kernel_s = sum(kernel_bound_ms(c) * c["calls"]
                   for c in rec["kernels"]) / 1e3
    return {
        "compute": sum(n / PEAK_FLOPS[dt] for dt, n in flops.items())
        + kernel_s,
        "memory": rec["cost_analysis"]["bytes accessed"] / HBM_BYTES_PER_S,
        "collective": sum(n / LINK_BYTES_PER_S[k] for k, n in
                          rec["collectives"]["per_link"].items()),
        "kernel": kernel_s}


def served_memory(lin: dict, one: dict, two: dict, mode: str) -> dict:
    """The ``memory_analysis`` of a prefill or decode step at full depth
    from its linear extrapolation ``lin`` and the traces at 1 and 2
    periods: the arguments from ``lin``, the peak above them from the
    deeper trace.  A prefill's peak above its arguments that grew from 1
    to 2 periods lies after the caches it returns pile up, so it grows
    with them to full depth; one that did not grow lies before them (a
    front end's or the first layer's temporaries) and stays.  A decode
    step's new caches replace the ones it was given."""
    temp = two["temp_size_in_bytes"]
    if mode == "prefill" and temp > one["temp_size_in_bytes"]:
        temp += lin["output_size_in_bytes"] - two["output_size_in_bytes"]
    return dict(lin, temp_size_in_bytes=temp,
                peak_bytes=lin["argument_size_in_bytes"] + temp)


def analyze_cell(arch_id: str, shape: B.ShapeConfig, device="cuda",
                 cfg: B.ModelConfig | None = None, mesh=None) -> dict:
    """The roofline row of one cell on the single-pod mesh (or ``mesh``,
    in a world the caller made): counts at 1 and 2 periods, calibrated to
    the model's depth (a prefill's or decode step's peak memory by
    ``served_memory``), priced at the H100's peaks."""
    from repro_torch.launch import dryrun   # it imports this module
    device = resolve_device(device)
    cfg = cfg or B.get_arch(arch_id).CONFIG
    with contextlib.ExitStack() as stack:
        if mesh is None:
            stack.enter_context(dryrun.fake_world(256))
            mesh = make_production_mesh(device=device)
        f1 = _measure(arch_id, shape, 1, mesh, device, cfg)
        f2 = _measure(arch_id, shape, 2, mesh, device, cfg)
    n = cfg.n_periods
    total = dryrun.combine([f1, f2], [2 - n, n - 1])
    if shape.mode != "train" and n >= 2:
        total["memory_analysis"] = served_memory(
            total["memory_analysis"], f1["memory_analysis"],
            f2["memory_analysis"], shape.mode)
    terms = price(total)
    kernel_s = terms.pop("kernel")
    dominant = max(terms, key=terms.get)
    bound_s = terms[dominant]
    mf = model_flops(cfg, shape)
    chips = math.prod(mesh.shape.values())
    peak = total["memory_analysis"]["peak_bytes"]
    flops = total["cost_analysis"]["flops"]
    return {
        "arch": arch_id, "shape": shape.name, "chips": chips,
        "device": str(device),
        "flops_per_chip": flops,
        "bytes_per_chip": total["cost_analysis"]["bytes accessed"],
        "coll_bytes_per_chip": total["collectives"]["total_bytes"],
        "compute_s": terms["compute"], "memory_s": terms["memory"],
        "collective_s": terms["collective"], "kernel_s": kernel_s,
        "dominant": dominant, "model_flops_total": mf,
        "useful_flops_ratio": (mf / chips) / max(flops, 1e-9),
        "roofline_fraction": (mf / chips / PEAK_FLOPS["bfloat16"])
        / max(bound_s, 1e-12),
        "peak_bytes_per_chip": peak, "fits": peak <= HBM_BYTES,
        "trace_s": round(f1["trace_s"] + f2["trace_s"], 2),
        "counts": total,
    }


NOTES = {
    "compute": ("dominant term is compute: skip the blocked attention's "
                "masked work (attn_impl='pallas' on the flash kernel where "
                "no gradient is needed), cut remat recompute, run float32 "
                "glue in bf16, or use more cards"),
    "memory": ("dominant term is HBM: fuse the eager glue (norms, rotary, "
               "softmax, quantization) into kernels, chunk the loss, keep "
               "activations in bf16, or capture the step in a CUDA graph "
               "so fused kernels replace op chains"),
    "collective": ("dominant term is the NICs: keep hot axes inside a node "
                   "(an 8-rank model axis rides NVLink), true tensor-parallel "
                   "compute in place of whole-layer gathers, overlap a "
                   "layer's gather with the previous layer's compute, or "
                   "compress gradients"),
}
COLUMNS = ["arch", "shape", "chips", "flops_per_chip", "bytes_per_chip",
           "coll_bytes_per_chip", "compute_s", "memory_s", "collective_s",
           "kernel_s", "dominant", "model_flops_total", "useful_flops_ratio",
           "roofline_fraction", "peak_bytes_per_chip", "fits", "trace_s"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/roofline_h100.csv")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda needs a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cells = []
    if args.all:
        for arch in B.ARCH_IDS:
            for shape in B.shapes_for(arch):
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        shape = {s.name: s for s in B.ALL_SHAPES}[args.shape]
        cells.append((args.arch, shape))

    rows = []
    for arch, shape in cells:
        try:
            r = analyze_cell(arch, shape, device)
        except Exception as e:  # a cell that does not trace is a result
            r = {"arch": arch, "shape": shape.name,
                 "error": f"{type(e).__name__}: {e}"[:200]}
        rows.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "counts"}),
              flush=True)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(",".join(COLUMNS) + "\n")
        for r in rows:
            f.write(",".join(str(r.get(c, "")) for c in COLUMNS) + "\n")
    with open(args.out.replace(".csv", "_notes.json"), "w") as f:
        json.dump([{**{k: v for k, v in r.items() if k != "counts"},
                    "note": NOTES.get(r.get("dominant", ""), "")}
                   for r in rows], f, indent=1)
    print(f"[roofline] wrote {args.out}")


if __name__ == "__main__":
    main()
