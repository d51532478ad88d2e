"""Plain PyTorch versions of the port's kernels (the CPU path and the
references ``chip_smoke.py`` holds the kernels against on the card)."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import metrics as M
from repro_torch.core import simulate
from repro_torch.core.genome import CGPSpec, Genome


def cgp_eval_ref(genome: Genome, spec: CGPSpec, in_planes: torch.Tensor,
                 golden_vals: torch.Tensor, gauss_sigma: float
                 ) -> tuple[M.MetricPartials, torch.Tensor]:
    """(metric partials, per-gate popcounts float32 (..., n_n)) of genomes
    with any leading batch dims, from ``core.simulate`` and
    ``core.metrics``."""
    wires = simulate.simulate_planes(genome, spec, in_planes)
    cand = simulate.unpack_values(simulate.output_planes(genome, wires))
    partials = M.error_partials(golden_vals, cand, gauss_sigma,
                                n_bits=spec.n_o)
    pops = simulate.popcount32(wires[..., spec.n_i:, :]).sum(dim=-1)
    return partials, pops.to(torch.float32)


def cgp_eval_ref_sharded(genome: Genome, spec: CGPSpec,
                         in_planes: torch.Tensor, golden_vals: torch.Tensor,
                         gauss_sigma: float, group
                         ) -> tuple[M.MetricPartials, torch.Tensor]:
    """The plain version of ``kernels.cgp_sim_metrics_batched_sharded``:
    ``cgp_eval_ref`` on this rank's slice of the cube, then the partials
    combined over ``group`` (``metrics.combine_partials``) and the popcounts
    summed — the reference's jnp path under input-space sharding."""
    partials, pops = cgp_eval_ref(genome, spec, in_planes, golden_vals,
                                  gauss_sigma)
    dist.all_reduce(pops, op=dist.ReduceOp.SUM, group=group)
    return M.combine_partials(partials, group), pops


#: rows per chunk of ``lut_matmul_ref``: each chunk gathers an (m, K, N)
#: int32 tensor, so m·K·N stays near 2^24 elements (64 MB) at any M
REF_CHUNK_ELEMS = 1 << 24


def lut_matmul_ref(a: torch.Tensor, b: torch.Tensor,
                   lut: torch.Tensor) -> torch.Tensor:
    """C[m, n] = Σ_k LUT[a[m, k], b[k, n]] in int32, by gathering the table.

    a: (M, K), b: (K, N) integer tensors with values in [0, 255]; lut:
    (256, 256) integer.  Chunked over M as ``repro/models/quant.py`` chunks
    the reference's gather, so memory stays bounded."""
    flat = lut.reshape(-1).to(torch.int32)
    a = a.to(torch.int32) * 256
    b = b.to(torch.int32)
    M, K = a.shape
    rows = max(1, REF_CHUNK_ELEMS // max(1, K * b.shape[1]))
    return torch.cat([flat[a[m:m + rows, :, None] + b[None]].sum(
        dim=1, dtype=torch.int32) for m in range(0, M, rows)], dim=0)


#: score elements per pass of ``attention_ref``: (BH, rows, Skv) float32
#: scores stay near 2^26 elements (256 MB) however long the sequence
ATTN_CHUNK_ELEMS = 1 << 26


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Naive softmax attention: q (BH, Sq, D), k/v (BH, Skv, D), heads
    folded.  Float32 scores ``q·k / sqrt(D)``, causal mask ``q_pos >=
    k_pos`` (−1e30), softmax, ``p·v``; q's dtype out.

    Rows are independent, so the query rows go through in passes of as
    many rows as keep a pass's scores near ``ATTN_CHUNK_ELEMS``: the naive
    function without S² scores per head at once."""
    BH, Sq, D = q.shape
    Skv = k.shape[1]
    rows = max(1, ATTN_CHUNK_ELEMS // max(1, BH * Skv))
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    k_pos = torch.arange(Skv, device=q.device)
    outs = []
    for r0 in range(0, Sq, rows):
        qc = q[:, r0:r0 + rows].to(torch.float32)
        s = torch.einsum("bqd,bkd->bqk", qc, kf) / (D ** 0.5)
        if causal:
            q_pos = torch.arange(r0, r0 + qc.shape[1], device=q.device)
            s = torch.where((q_pos[:, None] >= k_pos[None, :])[None], s,
                            -1e30)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bqk,bkd->bqd", p, vf))
    return torch.cat(outs, dim=1).to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """The plain version of ``kernels.flash_attention``: q (B, Hq, S, D),
    k/v (B, Hkv, S, D), the kv-heads repeated per group and folded into
    the batch, as the reference folds them, then ``attention_ref``."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    fold = lambda x: x.repeat_interleave(Hq // Hkv, dim=1).reshape(
        B * Hq, Skv, D)
    return attention_ref(q.reshape(B * Hq, Sq, D), fold(k), fold(v),
                         causal).reshape(B, Hq, Sq, D)
