"""Plain PyTorch versions of the port's kernels (the CPU path and the
references ``chip_smoke.py`` holds the kernels against on the card)."""
from __future__ import annotations

import torch

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
