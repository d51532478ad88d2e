"""(1+λ) error-oriented CGP evolution — paper Sec. III-B / IV.

Single-island semantics (paper-faithful):
  parent ← golden circuit
  repeat: λ offspring by point mutation; evaluate Eq.(8)/(9) fitness
          (power if all error constraints hold else ∞); offspring with
          fitness ≤ parent replaces it (neutral drift enabled).

The run axis is written out: every state leaf carries a leading axis C of
independent runs, each with its own PRNG key and thresholds, and each
generation evaluates the whole (C × λ) offspring population in ONE launch
of the cgp_sim kernel.  A Python loop over generations replaces the
reference's ``lax.scan``; it never waits for the device.  The single-run
functions are the batched ones with C = 1.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core import metrics as M
from repro_torch.core.fitness import fitness as fitness_fn
from repro_torch.core.genome import CGPSpec, Genome
from repro_torch.core.mutate import mutate_population
from repro_torch.core.power import CircuitCost, circuit_cost_from_probs
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class EvolveConfig:
    generations: int = 2000
    lam: int = 4                 # λ offspring per generation
    # per-gene mutation probability (≈ 5 mutated genes for a 400-node genome)
    mutation_rate: float = 0.004
    gauss_sigma: float = 256.0
    # the reference's field; each run's stream is PRNGKey(its own seed)
    seed: int = 0
    # cgp_sim kernel variant: "genome_major", "cube_major", or "auto" (the
    # tuning table, kernels.tune).  An execution knob: the runs are the same
    # under every layout, so the grid fingerprint leaves it out.
    layout: str = "auto"


class EvalResult(NamedTuple):
    metric_vec: torch.Tensor   # (R, N_METRICS)
    cost: CircuitCost


class EvolveState(NamedTuple):
    parent: Genome
    parent_fit: torch.Tensor
    parent_metrics: torch.Tensor
    parent_power: torch.Tensor
    best: Genome               # best-ever feasible candidate
    best_fit: torch.Tensor
    key: torch.Tensor          # (..., 2) PRNG key words


class EvolveResult(NamedTuple):
    parent: Genome
    best: Genome
    best_fit: torch.Tensor
    # per-generation history of the parent: power_rel, metric vec, fitness
    hist_power_rel: torch.Tensor   # (gens,)
    hist_metrics: torch.Tensor     # (gens, N_METRICS)
    hist_fit: torch.Tensor         # (gens,)


def eval_population(genomes: Genome, spec: CGPSpec, in_planes: torch.Tensor,
                    golden_vals: torch.Tensor, gauss_sigma: float,
                    layout: str = "auto") -> EvalResult:
    """Metric vectors and cost of (R,)-stacked genomes: one kernel launch
    in the ``layout`` variant."""
    partials, pops = kops.cgp_eval_batched(genomes, spec, in_planes,
                                           golden_vals, gauss_sigma, layout)
    probs = pops / partials.count.to(torch.float32)[:, None]
    metric_vec = M.finalize_metrics(partials, spec.n_o, gauss_sigma)
    cost = circuit_cost_from_probs(genomes, spec, probs, with_delay=False)
    return EvalResult(metric_vec, cost)


def _select(state: EvolveState, offspring: Genome, fits: torch.Tensor,
            mets: torch.Tensor, powers: torch.Tensor) -> EvolveState:
    """(1+λ) selection per run: offspring (C, λ, ...), fits (C, λ).  The
    first offspring of least fitness replaces the parent when it is ≤ the
    parent (neutral drift), and the best-ever when it is strictly better."""
    rows = torch.arange(fits.shape[0], device=fits.device)
    i = fits.argmin(dim=1)              # first index on ties, as jnp.argmin
    fit_i = fits[rows, i]
    off_nodes, off_outs = offspring.nodes[rows, i], offspring.outs[rows, i]
    take = fit_i <= state.parent_fit    # '≤' enables neutral drift
    improves = fit_i < state.best_fit
    pick = lambda m, new, old: torch.where(
        m.reshape(m.shape + (1,) * (old.dim() - 1)), new, old)
    return EvolveState(
        parent=Genome(pick(take, off_nodes, state.parent.nodes),
                      pick(take, off_outs, state.parent.outs)),
        parent_fit=pick(take, fit_i, state.parent_fit),
        parent_metrics=pick(take, mets[rows, i], state.parent_metrics),
        parent_power=pick(take, powers[rows, i], state.parent_power),
        best=Genome(pick(improves, off_nodes, state.best.nodes),
                    pick(improves, off_outs, state.best.outs)),
        best_fit=torch.minimum(fit_i, state.best_fit),
        key=state.key)


def make_batched_generation_step(spec: CGPSpec, cfg: EvolveConfig
                                 ) -> Callable[..., EvolveState]:
    """One generation of C runs: step(state, thr_mat, in_planes,
    golden_vals) -> state.

    Mutation and selection draw each run's PRNG stream exactly as the
    reference's per-run path does; the (C × λ) offspring are flattened and
    evaluated in one kernel launch.
    """
    def step(state: EvolveState, thr_mat, in_planes, golden_vals):
        C = thr_mat.shape[0]
        keys = R.split(state.key)                       # (C, 2, 2)
        offspring = mutate_population(keys[:, 1], state.parent, spec,
                                      cfg.lam, cfg.mutation_rate)
        flat = Genome(offspring.nodes.reshape(C * cfg.lam, spec.n_n, 3),
                      offspring.outs.reshape(C * cfg.lam, spec.n_o))
        res = eval_population(flat, spec, in_planes, golden_vals,
                              cfg.gauss_sigma, cfg.layout)
        mets = res.metric_vec.reshape(C, cfg.lam, M.N_METRICS)
        powers = res.cost.power.reshape(C, cfg.lam)
        fits = fitness_fn(powers, mets, thr_mat[:, None, :])
        return _select(state._replace(key=keys[:, 0]), offspring, fits,
                       mets, powers)

    return step


def init_state_batched(spec: CGPSpec, cfg: EvolveConfig, golden: Genome,
                       thr_mat: torch.Tensor, in_planes: torch.Tensor,
                       golden_vals: torch.Tensor, keys: torch.Tensor
                       ) -> EvolveState:
    """Initial state of C runs: the golden parent is evaluated ONCE (a
    one-genome kernel launch) and broadcast; only fitness differs per run."""
    res = eval_population(Genome(golden.nodes[None], golden.outs[None]),
                          spec, in_planes, golden_vals, cfg.gauss_sigma,
                          cfg.layout)
    C = thr_mat.shape[0]
    fit = fitness_fn(res.cost.power, res.metric_vec, thr_mat)
    parent = Genome(golden.nodes.expand(C, -1, -1).clone(),
                    golden.outs.expand(C, -1).clone())
    return EvolveState(parent, fit, res.metric_vec.expand(C, -1).clone(),
                       res.cost.power.expand(C).clone(), parent, fit, keys)


def scan_generations(step, state0: EvolveState, thresholds: torch.Tensor,
                     in_planes: torch.Tensor, golden_vals: torch.Tensor,
                     golden_power: torch.Tensor, generations: int):
    """Run ``step`` for ``generations``, recording the parent history.

    Returns (state, (power_rel (gens, C), metrics (gens, C, N_METRICS),
    fitness (gens, C))), all left on the device.
    """
    state = state0
    # zero-row heads keep the shapes when there are no generations
    hist = ([state.parent_power[None][:0]], [state.parent_metrics[None][:0]],
            [state.parent_fit[None][:0]])
    for _ in range(generations):
        state = step(state, thresholds, in_planes, golden_vals)
        hist[0].append((state.parent_power / golden_power)[None])
        hist[1].append(state.parent_metrics[None])
        hist[2].append(state.parent_fit[None])
    return state, tuple(torch.cat(h) for h in hist)


def _batch(x):
    """Add a run axis of one to a tensor or a tuple of them."""
    if isinstance(x, torch.Tensor):
        return x[None]
    return type(x)(*(_batch(v) for v in x))


def _unbatch(x):
    """Drop the run axis of one that ``_batch`` added."""
    if isinstance(x, torch.Tensor):
        return x[0]
    return type(x)(*(_unbatch(v) for v in x))


def make_generation_step(spec: CGPSpec, cfg: EvolveConfig):
    """Single-run step(state, thresholds, in_planes, golden_vals) -> state:
    the batched step on a run axis of one."""
    batched = make_batched_generation_step(spec, cfg)

    def step(state: EvolveState, thresholds, in_planes, golden_vals):
        return _unbatch(batched(_batch(state), thresholds[None], in_planes,
                                golden_vals))

    return step


def init_state(spec: CGPSpec, cfg: EvolveConfig, golden: Genome,
               thresholds: torch.Tensor, in_planes: torch.Tensor,
               golden_vals: torch.Tensor, key: torch.Tensor) -> EvolveState:
    return _unbatch(init_state_batched(spec, cfg, golden, thresholds[None],
                                       in_planes, golden_vals, key[None]))


def evolve(spec: CGPSpec, cfg: EvolveConfig, golden: Genome,
           thresholds: torch.Tensor, in_planes: torch.Tensor,
           golden_vals: torch.Tensor, golden_power: torch.Tensor,
           key: torch.Tensor) -> EvolveResult:
    """Single-island paper-faithful run (the batched loop with C = 1)."""
    thr = thresholds[None]
    state0 = init_state_batched(spec, cfg, golden, thr, in_planes,
                                golden_vals, key[None])
    state, (hp, hm, hf) = scan_generations(
        make_batched_generation_step(spec, cfg), state0, thr, in_planes,
        golden_vals, golden_power, cfg.generations)
    state = _unbatch(state)
    return EvolveResult(state.parent, state.best, state.best_fit, hp[:, 0],
                        hm[:, 0], hf[:, 0])
