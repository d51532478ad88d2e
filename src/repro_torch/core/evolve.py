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

Distributed semantics (the reference's ``shard_map`` formulation over the
mesh axes pod × data × model, here ranks of a ``parallel.ctx.Mesh``):
``group`` shards each evaluation's input cube over the ranks of a process
group (the ``model`` axis: every rank simulates its word slice and the
partials are all-reduced, so every rank selects the same way);
``evolve_sharded`` runs one (1+λ) island per ``data`` coordinate, migrating
the best parent across the islands every ``migrate_every`` generations,
and one constraint vector per ``pod`` coordinate.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
import torch.distributed as dist

from repro_torch import random as R
from repro_torch.core import metrics as M
from repro_torch.core.fitness import fitness as fitness_fn
from repro_torch.core.genome import CGPSpec, Genome
from repro_torch.core.mutate import mutate_population
from repro_torch.core.power import CircuitCost, circuit_cost_from_probs
from repro_torch.core.sampling import INPUT_DISTS
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class EvolveConfig:
    generations: int = 2000
    lam: int = 4                 # λ offspring per generation
    # per-gene mutation probability (≈ 5 mutated genes for a 400-node genome)
    mutation_rate: float = 0.004
    gauss_sigma: float = 256.0
    migrate_every: int = 64      # island migration period (evolve_sharded)
    # the reference's field; each run's stream is PRNGKey(its own seed)
    seed: int = 0
    # cgp_sim kernel variant: "genome_major", "cube_major", or "auto" (the
    # tuning table, kernels.tune).  An execution knob: the runs are the same
    # under every layout, so the grid fingerprint leaves it out.
    layout: str = "auto"
    # The phenotype-dedup evaluation cache (``core.evalcache``): the batched
    # sweep evaluates each generation's unique, uncached active subgraphs
    # only and hands every copy the cached result.  Like ``layout`` an
    # execution knob (the runs are the same with it on or off), so the grid
    # fingerprint leaves it out.  Read by ``core.sweep.run_sweep_batched``.
    dedup: bool = False
    # Evaluation inputs: "exhaustive" scores candidates on the full 2^(2w)
    # input cube; "sampled" on a deterministic ``sample_size``-row operand
    # sample drawn from ``input_dist`` by the counter-based stream seeded by
    # ``sample_seed`` (``core.sampling``).  Unlike ``layout`` this changes
    # results, so it enters the grid fingerprint.  The engine consumes
    # whatever (in_planes, golden_vals) ``search.problem_arrays`` builds.
    eval_mode: str = "exhaustive"    # "exhaustive" | "sampled"
    sample_size: int = 1 << 14       # rows (rounded up to pow2 words * 32)
    input_dist: str = "uniform"      # "uniform" | "gaussian" | "empirical"
    sample_seed: int = 0             # sample-stream seed (not the CGP seed)
    # The exact tier (``core.certify``): after each sampled sweep chunk, up
    # to a ramped ``certify_budget`` of elites feasible ON THE SAMPLE are
    # re-measured exactly over the whole cube.  Changes the escalated rows,
    # so it enters a sampled grid's fingerprint (only when on).  A no-op
    # under exhaustive evaluation (the census is exact) and on the serial
    # ``evolve`` path.
    certify: bool = False
    certify_budget: int = 8          # base escalations per sweep chunk

    def __post_init__(self):
        if self.eval_mode not in ("exhaustive", "sampled"):
            raise ValueError(f"eval_mode must be 'exhaustive' or 'sampled', "
                             f"got {self.eval_mode!r}")
        if self.input_dist not in INPUT_DISTS:
            raise ValueError(f"input_dist must be one of {INPUT_DISTS}, "
                             f"got {self.input_dist!r}")
        if self.sample_size < 1:
            raise ValueError(
                f"sample_size must be >= 1, got {self.sample_size}")
        if self.certify_budget < 1:
            raise ValueError(
                f"certify_budget must be >= 1, got {self.certify_budget}")


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
                    layout: str = "auto", group=None) -> EvalResult:
    """Metric vectors and cost of (R,)-stacked genomes: one kernel launch
    in the ``layout`` variant.  With ``group`` the cube is sharded over its
    ranks (``in_planes``/``golden_vals`` are this rank's slice) and the
    result is the whole cube's on every rank."""
    partials, pops = kops.cgp_eval_batched(genomes, spec, in_planes,
                                           golden_vals, gauss_sigma, layout,
                                           group=group)
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


def mutate_segment(spec: CGPSpec, cfg: EvolveConfig, state: EvolveState
                   ) -> tuple[torch.Tensor, Genome]:
    """The generation's first part: each run's key split and its λ
    offspring.  Returns (next keys (C, 2), offspring with leading (C, λ));
    ``[:, 1]`` of the split draws the mutation, ``[:, 0]`` is kept."""
    keys = R.split(state.key)                           # (C, 2, 2)
    return keys[:, 0], mutate_population(keys[:, 1], state.parent, spec,
                                         cfg.lam, cfg.mutation_rate)


def eval_segment(spec: CGPSpec, cfg: EvolveConfig, nodes: torch.Tensor,
                 outs: torch.Tensor, in_planes: torch.Tensor,
                 golden_vals: torch.Tensor, group=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The generation's evaluation: (metric_vec (U, N_METRICS), power (U,))
    of (U,)-stacked genomes in one kernel launch, the part of a result that
    depends on the phenotype alone (what the dedup cache keeps)."""
    res = eval_population(Genome(nodes, outs), spec, in_planes, golden_vals,
                          cfg.gauss_sigma, cfg.layout, group)
    return res.metric_vec, res.cost.power


def select_segment(state: EvolveState, key: torch.Tensor, offspring: Genome,
                   metric_vec: torch.Tensor, power: torch.Tensor,
                   thr_mat: torch.Tensor) -> EvolveState:
    """The generation's last part: Eq. (8)/(9) fitness of the (C, λ)
    offspring under each run's thresholds and (1+λ) selection."""
    fits = fitness_fn(power, metric_vec, thr_mat[:, None, :])
    return _select(state._replace(key=key), offspring, fits, metric_vec,
                   power)


def make_batched_generation_step(spec: CGPSpec, cfg: EvolveConfig,
                                 group=None) -> Callable[..., EvolveState]:
    """One generation of C runs: step(state, thr_mat, in_planes,
    golden_vals) -> state, the three segments composed.

    Mutation and selection draw each run's PRNG stream exactly as the
    reference's per-run path does; the (C × λ) offspring are flattened and
    evaluated in one kernel launch.  ``group`` shards that evaluation's cube
    over its ranks; per-run state is replicated, so every rank mutates and
    selects the same way.  The dedup sweep runs the same segments with its
    cache between them (``core.sweep``).
    """
    def step(state: EvolveState, thr_mat, in_planes, golden_vals):
        C, lam = thr_mat.shape[0], cfg.lam
        key, offspring = mutate_segment(spec, cfg, state)
        mets, powers = eval_segment(
            spec, cfg, offspring.nodes.reshape(C * lam, spec.n_n, 3),
            offspring.outs.reshape(C * lam, spec.n_o), in_planes,
            golden_vals, group)
        return select_segment(state, key, offspring,
                              mets.reshape(C, lam, M.N_METRICS),
                              powers.reshape(C, lam), thr_mat)

    return step


def init_state_batched(spec: CGPSpec, cfg: EvolveConfig, golden: Genome,
                       thr_mat: torch.Tensor, in_planes: torch.Tensor,
                       golden_vals: torch.Tensor, keys: torch.Tensor,
                       group=None) -> EvolveState:
    """Initial state of C runs: the golden parent is evaluated ONCE (a
    one-genome kernel launch, its cube sharded over ``group``) and
    broadcast; only fitness differs per run."""
    res = eval_population(Genome(golden.nodes[None], golden.outs[None]),
                          spec, in_planes, golden_vals, cfg.gauss_sigma,
                          cfg.layout, group)
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


def make_generation_step(spec: CGPSpec, cfg: EvolveConfig, group=None,
                         island_group=None):
    """Single-run step(state, thresholds, in_planes, golden_vals,
    gen_idx=None) -> state: the batched step on a run axis of one.

    ``group`` shards the evaluation's cube over its ranks.  With
    ``island_group`` the run is one island of that group: after generation
    ``gen_idx`` (which is then required), every ``cfg.migrate_every``
    generations, the islands' best parent replaces every strictly worse one
    (``_migrate``).
    """
    batched = make_batched_generation_step(spec, cfg, group)

    def step(state: EvolveState, thresholds, in_planes, golden_vals,
             gen_idx=None):
        state = _unbatch(batched(_batch(state), thresholds[None], in_planes,
                                 golden_vals))
        if island_group is not None:
            if gen_idx is None:
                raise ValueError("an island step needs the generation index")
            if (gen_idx + 1) % cfg.migrate_every == 0:
                state = _migrate(state, island_group)
        return state

    return step


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(group size, *x.shape): every rank's ``x``, by group rank."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.stack(parts)


def _migrate(state: EvolveState, island_group) -> EvolveState:
    """The best parent of the islands of ``island_group`` (the first on
    ties, as ``jnp.argmin``) replaces every strictly worse island's parent
    and its fitness; the rest of the state stays, as in the reference."""
    all_fit = _all_gather(state.parent_fit, island_group)
    all_nodes = _all_gather(state.parent.nodes, island_group)
    all_outs = _all_gather(state.parent.outs, island_group)
    # a one-element index, not a scalar one, so nothing waits for the value
    j = all_fit.argmin()[None]
    best_fit = all_fit[j][0]
    worse = state.parent_fit > best_fit
    return state._replace(
        parent=Genome(torch.where(worse, all_nodes[j][0], state.parent.nodes),
                      torch.where(worse, all_outs[j][0], state.parent.outs)),
        parent_fit=torch.where(worse, best_fit, state.parent_fit))


def init_state(spec: CGPSpec, cfg: EvolveConfig, golden: Genome,
               thresholds: torch.Tensor, in_planes: torch.Tensor,
               golden_vals: torch.Tensor, key: torch.Tensor,
               group=None) -> EvolveState:
    return _unbatch(init_state_batched(spec, cfg, golden, thresholds[None],
                                       in_planes, golden_vals, key[None],
                                       group))


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


def make_island_keys(seed: int, n_islands: int) -> torch.Tensor:
    """(n_islands, 2) keys ``fold_in(PRNGKey(seed), i)``, as the
    reference's."""
    return R.fold_in(R.PRNGKey(seed), torch.arange(n_islands))


def evolve_sharded(mesh, spec: CGPSpec, cfg: EvolveConfig, golden: Genome,
                   thresholds_per_pod: torch.Tensor,
                   golden_power: torch.Tensor, *, data_axis: str = "data",
                   model_axis: str = "model", pod_axis: str | None = None):
    """The island formulation of the distributed search over a
    ``parallel.ctx.Mesh`` (the reference's ``evolve_sharded``).

    One (1+λ) run per ``data_axis`` coordinate, migrating its best parent
    every ``cfg.migrate_every`` generations (``_migrate`` over the data
    axis); each run's evaluation cube-sharded over ``model_axis``; with
    ``pod_axis``, one constraint vector per pod coordinate (the threshold
    rows split evenly over the pods; without it, row 0 for every island).

    Returns fn(thresholds, keys, in_planes, golden_vals) that every rank of
    the mesh calls with the whole arrays: ``keys`` (n_islands, 2) split
    evenly over the data axis, ``in_planes`` (n_i, W) and ``golden_vals``
    (32·W,) split over the model axis on the word axis.  Each rank takes
    its share and returns what the reference's ``out_specs=P(data_axis)``
    hands back: (parent, best, best_fit, hist_power_rel, hist_metrics,
    hist_fit) of the islands stacked over the data axis — pod 0's when
    the mesh has a pod axis — the same on every rank.  As in the
    reference, the thresholds fn is given are the ones used, and
    ``thresholds_per_pod`` is not read.
    """
    if pod_axis is not None:
        mesh.axis_size(pod_axis)      # raises for an axis the mesh lacks
    model = mesh.axis_group(model_axis)
    islands = mesh.axis_group(data_axis)

    def share(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        n, i = mesh.axis_size(axis), mesh.axis_index(axis)
        if x.shape[dim] % n:
            raise ValueError(f"{x.shape[dim]} rows do not split over the "
                             f"{n} ranks of axis {axis!r}")
        k = x.shape[dim] // n
        return x.narrow(dim, i * k, k)

    def fn(thresholds, keys, in_planes, golden_vals):
        dev = mesh.device
        thr = (share(thresholds, pod_axis) if pod_axis is not None
               else thresholds)[0].to(dev)
        key = share(keys, data_axis)[0].to(dev)
        planes = share(in_planes, model_axis, dim=1).to(dev).contiguous()
        gvals = share(golden_vals, model_axis).to(dev).contiguous()
        gold = Genome(golden.nodes.to(dev), golden.outs.to(dev))
        step = make_generation_step(spec, cfg, model, islands)
        # the island step migrates by generation index, which
        # scan_generations does not pass: bind it here, one per call
        gen_idx = iter(range(cfg.generations))
        state0 = init_state(spec, cfg, gold, thr, planes, gvals, key, model)
        state, (hp, hm, hf) = scan_generations(
            lambda s, *a: step(s, *a, next(gen_idx)), state0, thr, planes,
            gvals, golden_power.to(dev), cfg.generations)
        out = (state.parent.nodes, state.parent.outs, state.best.nodes,
               state.best.outs, state.best_fit, hp, hm, hf)
        out = [_all_gather(x, islands) for x in out]
        if pod_axis is not None and mesh.axis_size(pod_axis) > 1:
            # the reference hands back pod 0's islands on every rank
            pods = mesh.axis_group(pod_axis)
            for x in out:
                dist.broadcast(x, src=dist.get_global_rank(pods, 0),
                               group=pods)
        pn, po, bn, bo, bf, hp, hm, hf = out
        return Genome(pn, po), Genome(bn, bo), bf, hp, hm, hf

    return fn
