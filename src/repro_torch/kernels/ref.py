"""Plain PyTorch oracle of the cgp_sim kernel, at the MetricPartials level."""
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
