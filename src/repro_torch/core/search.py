"""High-level search API: one call = one paper-style approximation run.

``run_search`` runs one (1+λ) evolution under one combined constraint;
``run_sweep`` executes a grid of constraint configurations × seeds (the
paper's methodology, Sec. IV) through the batched engine.  Every entry point
runs on the card (``device="cuda"``) unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.core import golden as G
from repro_torch.core import metrics as M
from repro_torch.core import sampling, simulate
from repro_torch.core.evolve import EvolveConfig, EvolveResult, evolve
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.genome import CGPSpec, Genome
from repro_torch.core.power import circuit_cost_from_probs
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    width: int = 8               # operand bit width (paper: 8x8 multiplier)
    kind: str = "mul"            # "mul" | "add"
    n_n: int = 400               # CGP nodes (paper: 400)
    evolve: EvolveConfig = EvolveConfig()


@dataclasses.dataclass
class CircuitRecord:
    """One evolved circuit with its full characterization."""
    genome_nodes: np.ndarray
    genome_outs: np.ndarray
    metrics: np.ndarray          # (N_METRICS,) final metric vector
    power_rel: float             # power(C)/power(G)
    constraint: str              # human-readable constraint description
    seed: int
    feasible: bool
    error_mean: float = 0.0      # signed error mean (Fig. 13 analyses)
    error_std: float = 0.0
    # (N_METRICS,) standard errors of the final metrics: all zero under
    # exhaustive evaluation (a census has no sampling error), CLT estimates
    # from the sample's second moments when sampled
    metrics_stderr: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(M.N_METRICS, np.float32))
    # True when ``metrics`` is exact over the whole input cube: always under
    # exhaustive evaluation; for sampled runs only after the exact tier
    # (``core.certify``) re-measured the circuit
    certified: bool = False


def problem_arrays(cfg: SearchConfig, device: torch.device | str | None = None):
    """(golden genome, spec, in_planes, golden values, golden power) on
    ``device``.

    ``cfg.evolve.eval_mode`` picks the inputs: the exhaustive 2^(2w) cube,
    or a deterministic ``core.sampling`` operand sample packed into the
    same bit-plane / golden-value contract.  The golden power is measured
    on the same inputs as the candidates (under sampling, a sample
    estimate, consistent across both sides of ``power_rel``).
    """
    dev = resolve_device(device)
    build = G.array_multiplier if cfg.kind == "mul" else G.ripple_carry_adder
    gold, spec = build(cfg.width, n_n=cfg.n_n)
    gold = Genome(gold.nodes.to(dev), gold.outs.to(dev))
    ecfg = cfg.evolve
    if ecfg.eval_mode == "sampled":
        planes_np, gvals_np = sampling.sample_problem(
            cfg.width, cfg.kind, ecfg.sample_size, ecfg.input_dist,
            ecfg.sample_seed)
        in_planes = torch.as_tensor(planes_np, device=dev)
        gvals = torch.as_tensor(gvals_np, device=dev)
    else:
        # copies: the planes array is cached and shared
        in_planes = torch.tensor(simulate.input_planes_np(spec.n_i),
                                 device=dev)
        gvals = torch.tensor(G.golden_values(cfg.width, cfg.kind),
                             device=dev)
    wires = simulate.simulate_planes(gold, spec, in_planes)
    probs = simulate.signal_probabilities(wires[spec.n_i:])
    gpower = circuit_cost_from_probs(gold, spec, probs, with_delay=False).power
    return gold, spec, in_planes, gvals, gpower


def run_search(cfg: SearchConfig, constraint: ConstraintSpec, seed: int = 0,
               device: torch.device | str | None = None
               ) -> tuple[CircuitRecord, EvolveResult]:
    """One (1+λ) run under one combined constraint (paper Eq. 8/9)."""
    gold, spec, in_planes, gvals, gpower = problem_arrays(cfg, device)
    dev = in_planes.device
    ecfg = dataclasses.replace(cfg.evolve, gauss_sigma=constraint.gauss_sigma)
    thr = torch.as_tensor(constraint.thresholds(), device=dev)
    res = evolve(spec, ecfg, gold, thr, in_planes, gvals, gpower,
                 R.PRNGKey(seed, device=dev))
    rec = characterize(res.parent, spec, constraint, seed, in_planes, gvals,
                       gpower, sampled=cfg.evolve.eval_mode == "sampled")
    return rec, res


def characterize(genome: Genome, spec: CGPSpec, constraint: ConstraintSpec,
                 seed: int, in_planes, gvals, gpower, *,
                 sampled: bool = False) -> CircuitRecord:
    """Full final measurement of one evolved circuit; ``sampled`` adds the
    standard errors.  The serial path has no escalation driver, so the
    record is certified exactly when the evaluation was exhaustive."""
    from repro_torch.core.sweep import characterize_chunk
    thr = torch.as_tensor(constraint.thresholds(), device=in_planes.device)
    met, sterr, prel, feas, emean, estd = (
        x[0].cpu().numpy() for x in characterize_chunk(
            spec, constraint.gauss_sigma, genome.nodes[None],
            genome.outs[None], thr[None], in_planes, gvals, gpower,
            sampled=sampled))
    return CircuitRecord(
        genome_nodes=genome.nodes.cpu().numpy(),
        genome_outs=genome.outs.cpu().numpy(),
        metrics=met,
        power_rel=float(prel),
        constraint=constraint.describe(),
        seed=seed,
        feasible=bool(feas),
        error_mean=float(emean),
        error_std=float(estd),
        metrics_stderr=sterr,
        certified=not sampled,
    )


def run_sweep(cfg: SearchConfig, constraints: Sequence[ConstraintSpec],
              seeds: Sequence[int] = (0,), *, sweep=None,
              device: torch.device | str | None = None
              ) -> list[CircuitRecord]:
    """Grid of constraint configs × seeds, executed by the batched engine
    (``core.sweep``).  Each run's PRNG stream is ``PRNGKey(seed)``, so a
    run's result depends only on its own (constraint, seed) pair.  Returns
    the records in grid order (constraints outer, seeds inner), identical
    to ``run_sweep_serial``."""
    from repro_torch.core.sweep import SweepConfig, run_sweep_batched
    sweep = sweep or SweepConfig(keep_history="none")
    return run_sweep_batched(cfg, constraints, seeds, sweep,
                             device=device).records


def run_sweep_serial(cfg: SearchConfig, constraints: Sequence[ConstraintSpec],
                     seeds: Sequence[int] = (0,),
                     device: torch.device | str | None = None
                     ) -> list[CircuitRecord]:
    """Reference serial loop (one ``evolve`` per run)."""
    return [run_search(cfg, con, seed, device)[0]
            for con in constraints for seed in seeds]
