"""Candidate evaluation through the cgp_sim kernel.

The device decides the path: CUDA tensors go through the hand-written kernel
(``kernels.cgp_sim``) and ``_partials_from_raw`` decodes its raw sums; CPU
tensors go through the plain oracle ``ref.cgp_eval_ref``.  There is no
fallback between the two and no knob: a CUDA tensor launches the kernel or
raises.
"""
from __future__ import annotations

import torch

from repro_torch.core import metrics as M
from repro_torch.core.genome import CGPSpec, Genome
from repro_torch.kernels import cgp_sim as _cgp
from repro_torch.kernels import ref


def _partials_from_raw(raw: _cgp.RawSums, n_words: int,
                       n_o: int) -> M.MetricPartials:
    """Decode the kernel's ``RawSums`` into ``metrics.error_partials``'s
    MetricPartials: the magnitude sums through the same float32 regime as
    ``metrics._exact_sum`` (one rounding of the exact total, or the ascending
    per-bit recombination), the float rows rounded once from float64."""
    count = 32 * n_words
    if M.exact_sum_per_bit(count, n_o):
        abs_sum, pos, neg = (M.recombine_bit_counts(raw.mag[:, q])
                             for q in (_cgp.ABS, _cgp.POS, _cgp.NEG))
    else:
        abs_sum, pos, neg = (raw.mag[:, q, 0].to(torch.float32)
                             for q in (_cgp.ABS, _cgp.POS, _cgp.NEG))
    fsums = raw.fsums.to(torch.float32)
    return M.MetricPartials(
        abs_sum=abs_sum,
        wce_max=raw.wce,
        err_count=raw.ints[:, 0],
        rel_sum=fsums[:, _cgp.REL_SUM],
        sgn_sum=pos - neg,
        acc0_bad=raw.ints[:, 1],
        hist=raw.ints[:, 2:],
        count=torch.full_like(raw.wce, count),
        sq_sum=fsums[:, _cgp.SQ_SUM],
        rel_sq=fsums[:, _cgp.REL_SQ],
    )


def cgp_eval_batched(genomes: Genome, spec: CGPSpec, in_planes: torch.Tensor,
                     golden_vals: torch.Tensor, gauss_sigma: float = 256.0
                     ) -> tuple[M.MetricPartials, torch.Tensor]:
    """Population evaluation in one kernel launch.

    ``genomes`` carries a leading axis R: nodes (R, n_n, 3), outs (R, n_o).
    Returns (MetricPartials with leading R, pops (R, n_n) float32).
    """
    if in_planes.device.type == "cpu":
        return ref.cgp_eval_ref(genomes, spec, in_planes, golden_vals,
                                gauss_sigma)
    raw = _cgp.cgp_sim_metrics_batched(
        genomes.nodes.contiguous(), genomes.outs.contiguous(), in_planes,
        golden_vals, n_i=spec.n_i, n_n=spec.n_n, n_o=spec.n_o,
        gauss_sigma=gauss_sigma)
    return (_partials_from_raw(raw, in_planes.shape[1], spec.n_o),
            raw.pops.to(torch.float32))


def cgp_eval(genome: Genome, spec: CGPSpec, in_planes: torch.Tensor,
             golden_vals: torch.Tensor, gauss_sigma: float = 256.0
             ) -> tuple[M.MetricPartials, torch.Tensor]:
    """One genome: ``cgp_eval_batched`` with R = 1, leading axis dropped."""
    partials, pops = cgp_eval_batched(
        Genome(genome.nodes[None], genome.outs[None]), spec, in_planes,
        golden_vals, gauss_sigma)
    return M.MetricPartials(*(x[0] for x in partials)), pops[0]
