"""Batched constraint-grid sweep engine (paper Sec. IV at scale).

The paper's experiment is a grid of (1+λ) runs over combined
error-constraint configurations × seeds.  The grid runs in chunks of
``chunk_size`` runs: a chunk's thresholds are stacked into a
``(chunk, N_METRICS)`` matrix and its per-run PRNG keys into ``(chunk, 2)``,
and ``core.evolve`` carries that run axis, evaluating each generation's
whole (chunk × λ) offspring population in one cgp_sim kernel launch.

Runs with different ``gauss_sigma`` cannot share a chunk (σ fixes the
histogram bin edges), so the execution order groups runs by σ (stable, grid
order kept within a group) and chunk boundaries break on σ changes.  Short
chunks are padded with copies of their last run, so every chunk has the
same shape; results are scattered back to grid order.

With ``SweepConfig.results_dir`` every finished chunk is committed as one
result shard (``core.results``, the reference's schema v3), under a
manifest keyed by ``grid_fingerprint`` — the same hex digest the JAX
package computes for the same grid, so either package's reader opens the
other's directory.

Under ``EvolveConfig.eval_mode="sampled"`` every evaluation runs on a
deterministic operand sample (``core.sampling``) and the records carry
standard errors.  With ``EvolveConfig.certify`` each chunk then escalates
its best sample-feasible rows, up to ``certify.CertifyPolicy``'s budget for
the chunk's place in the plan, to an exact measurement over the whole cube
(``core.certify``): their metrics become exact, their stderr 0, their
feasibility the exact verdict, and ``certified_mask`` marks them.  An
exhaustive census is certified as it stands.

Progress is resumable.  The committed shards are the resume state of a
``results_dir`` sweep: a rerun of the same grid restores them (a damaged
shard is quarantined and its chunk runs again) and skips their chunks.
Without a ``results_dir``, ``SweepConfig.checkpoint_dir`` commits the
sweep's buffers every ``checkpoint_every`` chunks (``checkpoint.store``, in
the reference's layout and leaf order) and a rerun resumes from the newest
step of the same grid fingerprint.  Either package resumes the other's
shards and checkpoints.

``SweepConfig.model_axis`` shards every evaluation's input cube over that
axis of the active ``parallel.ctx`` mesh: each rank of the axis simulates
its word slice, the partials are all-reduced (``ops.cgp_eval_batched``
with a process group), and per-run state, thresholds and keys are
replicated, so every rank mutates and selects the same way and returns the
same ``SweepResult``.  Only the rank at coordinate 0 of every mesh axis
but ``pod`` writes a pod's result shards and checkpoints.

Four execution knobs change how a sweep runs, and one of them what it
finds:

  * ``SweepConfig.n_pods`` / ``pod_index`` partition the chunk plan
    round-robin over pods (``results.pod_partition``): this call runs pod
    ``pod_index``'s slice into the shared ``results_dir``, whose manifest
    is the only coordination.  The pods' shards are, byte for byte, the
    one-pod sweep's, and each pod resumes from its own committed prefix.
  * ``dedup`` evaluates only each generation's unique, uncached phenotypes
    (``dedup_generation_step``, ``core.evalcache``); the runs are the same.
  * ``async_commit`` hands shard and checkpoint commits to a background
    thread (``core.commit``); the bytes are the same.
  * ``migrate_every`` folds the pods' published elites into each chunk's
    initial population (``core.migrate``).  This changes results, so it
    enters the grid fingerprint.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import random as R
from repro_torch.checkpoint import store
from repro_torch.core import certify
from repro_torch.core import metrics as M
from repro_torch.core import migrate as migrate_mod
from repro_torch.core import pareto, sampling, simulate
from repro_torch.core.commit import ChunkCommitter
from repro_torch.core.evalcache import PhenotypeLRU
from repro_torch.core.evolve import (EvolveConfig, EvolveState,
                                     eval_segment, init_state_batched,
                                     make_batched_generation_step,
                                     mutate_segment, scan_generations,
                                     select_segment)
from repro_torch.core.fitness import ConstraintSpec, feasible
from repro_torch.core.genome import CGPSpec, Genome, phenotype_digests
from repro_torch.core.power import circuit_cost_from_probs
from repro_torch.core.results import (HISTORY_MODES, SweepResultReader,
                                      SweepResultWriter, pod_partition)
from repro_torch.core.search import CircuitRecord, problem_arrays
from repro_torch.parallel import ctx

# The field of the reference's EvolveConfig that its grid fingerprint
# hashes and the port has no knob for: exhaustive evaluation is the port's
# only (jnp-equivalent) backend.
_REFERENCE_BACKEND = "jnp"

#: host <-> card copies of the dedup step, by kind (``dedup_generation_step``):
#: a generation copies its offspring's genes to the host once and the
#: gathered (C, λ) metrics and powers to the card once; a generation with
#: misses also copies the miss rows' indices to the card and their results
#: to the host.  Set to 0 and read by whoever measures them.
DEDUP_COPIES = {"genomes_to_host": 0, "miss_rows_to_card": 0,
                "miss_results_to_host": 0, "gathered_to_card": 0}


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Execution knobs of the batched sweep.

    ``keep_history``: ``"full"`` keeps the per-generation parent histories
    on the returned ``SweepResult`` (``hist_*``, ``(n_runs, gens, ...)``)
    and, with a ``results_dir``, in the shards too; ``"summary"`` writes
    them to the ``results_dir`` shards only (read them back with
    ``SweepResultReader.iter_history``; without a ``results_dir`` they are
    dropped); ``"none"`` keeps them nowhere.

    ``results_dir`` streams one shard per chunk (``core.results``), and the
    shard set is the resume state: a rerun of the same grid skips the
    committed chunks.  ``checkpoint_dir`` commits the sweep's buffers every
    ``checkpoint_every`` chunks and at the end (``checkpoint.store``, the
    newest 3 steps kept); without a ``results_dir`` a rerun resumes from
    the newest step of this grid.  Steps are named by runs done, so give
    each grid its own directory.  ``max_chunks`` stops after that many
    chunks run by this call (restored ones do not count).

    ``layout`` overrides ``cfg.evolve.layout`` (the cgp_sim kernel variant:
    ``"auto"``, ``"genome_major"``, ``"cube_major"``) for every chunk of
    this sweep; ``None`` defers to it.  The runs are the same under every
    layout, and the grid fingerprint leaves it out.

    ``model_axis`` names an axis of the ACTIVE ``parallel.ctx`` mesh to
    shard every evaluation's input cube over (module docstring); the sweep
    refuses to run without such a mesh.  Selection under MAE/WCE/ER/AVG/
    ACC0 constraints is the unsharded sweep's (integer-exact partials); the
    MRE sums are reassociated, so MRE-constrained runs may split at a
    last-bit tie.  Like ``layout``, ``checkpoint_dir`` and
    ``checkpoint_every``, it stays out of the grid fingerprint.  Under
    sampled evaluation it shards the sample's words (a power of two).

    ``n_pods`` / ``pod_index`` pod-shard the grid: the chunk plan is dealt
    round-robin over ``n_pods`` and this call runs pod ``pod_index``'s
    slice (``None``: the mesh's pod coordinate or the world rank,
    ``parallel.ctx.default_pod_index``).  Several pods need a shared
    ``results_dir`` and refuse ``checkpoint_dir`` (a checkpoint is one
    global prefix).

    ``dedup`` (``None`` defers to ``cfg.evolve.dedup``) evaluates each
    generation's unique phenotypes once and skips those a cross-generation
    LRU of ``dedup_cache_size`` entries has measured (``core.evalcache``).
    The runs are the same with it on or off, so the grid fingerprint leaves
    it out; its counters come back on ``SweepResult.dedup_stats``.  It
    refuses ``model_axis`` (the dedup loop decides on the host between
    launches).

    ``async_commit`` commits shards and checkpoints on one background
    thread (``core.commit``), at most ``commit_depth`` waiting: the same
    bytes in the same order, errors raised at the next chunk, the queue
    drained on every exit.  Not fingerprinted.

    ``migrate_every`` turns on chunk-level island migration between pods
    (``core.migrate``): every ``migrate_every`` chunks of its slice a pod
    publishes its per-σ elites into ``results_dir``, and each chunk of a
    later epoch folds the previous epoch's elites of every pod into its
    initial population.  This changes results, so the grid fingerprint
    gains a ``migrate`` entry (with ``n_pods``, ``chunk_size`` and
    ``MIGRATE_TOP_K``, which shape the epochs) when it is on.  It needs a
    ``results_dir`` and refuses ``model_axis``.  An import waits up to
    ``migrate_timeout`` seconds for a peer's file, then raises.
    """
    chunk_size: int = 32          # runs per chunk (device-memory bound)
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1     # chunks between checkpoint commits
    keep_history: str = "full"
    results_dir: str | None = None
    max_chunks: int | None = None  # chunks this call runs, at most
    n_pods: int = 1               # pods the chunk plan is dealt over
    pod_index: int | None = None  # this call's pod (None: resolved)
    layout: str | None = None
    model_axis: str | None = None  # mesh axis to shard the input cube over
    dedup: bool | None = None     # phenotype-dedup cache (None: cfg.evolve)
    dedup_cache_size: int = 1 << 16  # cross-generation LRU entry bound
    async_commit: bool = False    # background shard/checkpoint commits
    commit_depth: int = 2         # commits waiting before submit blocks
    migrate_every: int = 0        # chunks a migration epoch; 0 = off
    migrate_timeout: float = 120.0  # seconds to wait for a peer's migrants

    def __post_init__(self):
        if self.dedup_cache_size < 1:
            raise ValueError(f"dedup_cache_size must be >= 1, got "
                             f"{self.dedup_cache_size}")
        if self.commit_depth < 1:
            raise ValueError(
                f"commit_depth must be >= 1, got {self.commit_depth}")
        if self.migrate_every < 0:
            raise ValueError(
                f"migrate_every must be >= 0, got {self.migrate_every}")
        if self.migrate_every > 0:
            if self.results_dir is None:
                raise ValueError(
                    "migrate_every needs a results_dir: migrant files ride "
                    "the shared results directory")
            if self.model_axis is not None:
                raise ValueError(
                    "migrate_every is incompatible with model_axis: the "
                    "migrant fold runs on the host between launches, a "
                    "cube-sharded chunk is one collective program")
        if self.layout not in (None, "auto", "genome_major", "cube_major"):
            raise ValueError(
                f"layout must be None, 'auto', 'genome_major' or "
                f"'cube_major', got {self.layout!r}")
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")
        if self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {self.checkpoint_every}")
        if self.n_pods < 1:
            raise ValueError(f"n_pods must be >= 1, got {self.n_pods}")
        if self.pod_index is not None and not (
                0 <= self.pod_index < self.n_pods):
            raise ValueError(f"pod_index {self.pod_index} outside "
                             f"[0, {self.n_pods})")
        if self.n_pods > 1:
            if self.results_dir is None:
                raise ValueError(
                    "multi-pod sweeps need a shared results_dir: the shard "
                    "set is the only resume state that tolerates per-pod "
                    "prefixes")
            if self.checkpoint_dir is not None:
                raise ValueError(
                    "checkpoint_dir assumes a single global progress prefix; "
                    "multi-pod sweeps resume through the results_dir shards")
        if self.keep_history not in HISTORY_MODES:
            raise ValueError(f"keep_history must be one of {HISTORY_MODES}, "
                             f"got {self.keep_history!r}")


@dataclasses.dataclass
class SweepResult:
    """Stacked output of a (possibly partial) grid sweep.

    Run-major arrays are in grid order (constraints outer, seeds inner);
    ``done_mask`` marks the completed rows (this call's and the restored
    ones) and ``records`` holds exactly the completed runs, in grid order.
    ``hist_*`` are set only with ``keep_history="full"``.
    """
    records: list                      # list[CircuitRecord]
    thresholds: np.ndarray             # (n_runs, N_METRICS)
    metrics: np.ndarray                # (n_runs, N_METRICS) final measurement
    metrics_stderr: np.ndarray         # (n_runs, N_METRICS); 0 if exact
    power_rel: np.ndarray              # (n_runs,)
    feasible: np.ndarray               # (n_runs,) bool
    best_fit: np.ndarray               # (n_runs,)
    hist_power_rel: np.ndarray | None  # (n_runs, gens)
    hist_fit: np.ndarray | None        # (n_runs, gens)
    hist_metrics: np.ndarray | None    # (n_runs, gens, N_METRICS)
    done_mask: np.ndarray              # (n_runs,) bool
    completed: int
    n_runs: int
    runs_per_sec: float                # this call's runs; 0.0 if none ran
    results_dir: str | None = None     # where the shards went, if streaming
    certified_mask: np.ndarray | None = None  # (n_runs,) bool: metrics exact
    # sampled sweeps with certification: {"escalated": this call's
    # escalations, "certified_rows": rows certified, "budget": per chunk}
    certify_stats: dict | None = None
    # the dedup cache's counters (``CacheStats.as_dict``), when it ran
    dedup_stats: dict | None = None
    # migration's counters: published, imported, adopted, waited_s
    migrate_stats: dict | None = None

    def reader(self):
        """The ``SweepResultReader`` of this sweep's ``results_dir``."""
        if self.results_dir is None:
            raise ValueError("sweep ran without results_dir: no shards")
        return SweepResultReader(self.results_dir)

    def _mask(self, feasible_only: bool) -> np.ndarray:
        return self.done_mask & (self.feasible if feasible_only else True)

    def correlations(self, feasible_only: bool = True) -> np.ndarray:
        """|Pearson| cross-metric correlation over completed runs (paper
        Fig. 6)."""
        return pareto.metric_correlations(
            self.metrics[self._mask(feasible_only)])

    def fronts(self, metric_indices: Sequence[int] = (M.MAE, M.ER),
               feasible_only: bool = True) -> dict[int, np.ndarray]:
        """Power-vs-metric Pareto fronts (paper Figs. 7-14 axes)."""
        mask = self._mask(feasible_only)
        return pareto.sweep_fronts(self.power_rel[mask], self.metrics[mask],
                                   metric_indices)


def evolve_chunk(spec: CGPSpec, cfg: EvolveConfig, golden: Genome,
                 thr_mat: torch.Tensor, in_planes: torch.Tensor,
                 golden_vals: torch.Tensor, golden_power: torch.Tensor,
                 keys: torch.Tensor, group=None, state0=None, step=None):
    """Evolve ``thr_mat.shape[0]`` runs together: one kernel launch for the
    golden parent, then one per generation.  Histories come back run-major:
    (state, power_rel (C, gens), metrics (C, gens, N_METRICS),
    fitness (C, gens)).  With ``group``, ``in_planes``/``golden_vals`` are
    this rank's slice of the cube and every launch is sharded over the
    group's ranks; everything else is replicated, and so is the result.
    An explicit ``state0`` (the migration path's folded initial state)
    replaces the golden parent's evaluation, and an explicit ``step`` (the
    dedup path's, ``dedup_generation_step``) the fused one."""
    if step is None:
        step = make_batched_generation_step(spec, cfg, group)
    if state0 is None:
        state0 = init_state_batched(spec, cfg, golden, thr_mat, in_planes,
                                    golden_vals, keys, group)
    state, (hp, hm, hf) = scan_generations(step, state0, thr_mat, in_planes,
                                           golden_vals, golden_power,
                                           cfg.generations)
    return state, hp.T, hm.transpose(0, 1), hf.T


def dedup_generation_step(spec: CGPSpec, cfg: EvolveConfig,
                          cache: PhenotypeLRU, scope: tuple):
    """The fused step's segments with the phenotype-dedup cache between
    them: step(state, thr_mat, in_planes, golden_vals) -> state, the same
    state as ``make_batched_generation_step``'s.

    Per generation: (1) ``mutate_segment`` draws the (C × λ) offspring with
    the fused step's key stream; (2) their genes come to the host in one
    copy and are canonicalized and hashed; (3) only the unique phenotypes
    the cache lacks are gathered on the card and evaluated in one launch,
    padded to a power-of-two bucket by repeating the first miss; (4) every
    copy gets its phenotype's (metric_vec, power), which go to the card in
    one copy, and ``select_segment`` ends the step.  A generation whose
    offspring are all known launches nothing.  Every copy gets what its
    own evaluation would give (``core.evalcache``).

    ``scope`` pins the entries' validity (grid fingerprint, σ, and the
    sample stream for sampled grids); the LRU lives across the chunks of
    one sweep call.
    """
    n_genes, n_met = spec.n_n * 3, M.N_METRICS
    stats = cache.stats

    def step(state: EvolveState, thr_mat, in_planes, golden_vals):
        C, lam = thr_mat.shape[0], cfg.lam
        key, offspring = mutate_segment(spec, cfg, state)
        genes = torch.cat([offspring.nodes.reshape(C * lam, n_genes),
                           offspring.outs.reshape(C * lam, spec.n_o)], dim=1)
        host = genes.cpu().numpy()
        DEDUP_COPIES["genomes_to_host"] += 1
        digests = phenotype_digests(
            host[:, :n_genes].reshape(C * lam, spec.n_n, 3),
            host[:, n_genes:], spec)
        stats.candidates += len(digests)

        first: dict[bytes, int] = {}
        for i, d in enumerate(digests):
            if d in first:
                stats.dup_hits += 1
            else:
                first[d] = i
        values: dict[bytes, np.ndarray] = {}
        misses: list[bytes] = []
        for d in first:
            val = cache.get((d,) + scope)
            if val is None:
                misses.append(d)
            else:
                stats.lru_hits += 1
                values[d] = val
        if misses:
            rows = [first[d] for d in misses]
            n_miss = len(rows)
            stats.evaluated += n_miss
            pad = 1 << (n_miss - 1).bit_length()      # bucketed launch sizes
            sel = torch.as_tensor(rows + rows[:1] * (pad - n_miss),
                                  device=genes.device)
            DEDUP_COPIES["miss_rows_to_card"] += 1
            picked = genes[sel]
            mv, pw = eval_segment(
                spec, cfg, picked[:, :n_genes].reshape(pad, spec.n_n, 3),
                picked[:, n_genes:], in_planes, golden_vals)
            # metrics then power, one float32 row a phenotype
            got = torch.cat([mv[:n_miss], pw[:n_miss, None]], dim=1
                            ).cpu().numpy()
            DEDUP_COPIES["miss_results_to_host"] += 1
            for d, row in zip(misses, got):
                values[d] = row
                cache.put((d,) + scope, row)

        table = torch.as_tensor(np.stack([values[d] for d in digests]),
                                device=genes.device)
        DEDUP_COPIES["gathered_to_card"] += 1
        return select_segment(state, key, offspring,
                              table[:, :n_met].reshape(C, lam, n_met),
                              table[:, n_met].reshape(C, lam), thr_mat)

    return step


def characterize_chunk(spec: CGPSpec, gauss_sigma: float, nodes: torch.Tensor,
                       outs: torch.Tensor, thr_mat: torch.Tensor,
                       in_planes: torch.Tensor, golden_vals: torch.Tensor,
                       golden_power: torch.Tensor, sampled: bool = False):
    """Final measurement of C circuits (plain tensor code on the device):
    (metrics (C, N_METRICS), stderr (C, N_METRICS), power_rel (C,),
    feasible (C,), error mean (C,), error std (C,)).  ``sampled`` turns the
    second-moment partials into standard errors; otherwise they are zeros
    (a census has no sampling error)."""
    g = Genome(nodes, outs)
    wires = simulate.simulate_planes(g, spec, in_planes)
    cvals = simulate.unpack_values(simulate.output_planes(g, wires))
    partials = M.error_partials(golden_vals, cvals, gauss_sigma,
                                n_bits=spec.n_o)
    met = M.finalize_metrics(partials, spec.n_o, gauss_sigma)
    sterr = (M.metric_stderr(partials, spec.n_o) if sampled
             else torch.zeros_like(met))
    probs = simulate.signal_probabilities(wires[:, spec.n_i:])
    cost = circuit_cost_from_probs(g, spec, probs, with_delay=False)
    emean, estd = M.error_moments(golden_vals, cvals)
    return (met, sterr, cost.power / golden_power, feasible(met, thr_mat),
            emean, estd)


def sweep_grid(constraints: Sequence[ConstraintSpec],
               seeds: Sequence[int]) -> list[tuple[ConstraintSpec, int]]:
    """Run order of the grid: constraints outer, seeds inner."""
    return [(con, int(seed)) for con in constraints for seed in seeds]


def plan_chunks(sigmas: np.ndarray, chunk_size: int) -> list[tuple[int, int]]:
    """[start, end) chunk spans: ≤ chunk_size runs, uniform gauss_sigma."""
    spans, start = [], 0
    n = len(sigmas)
    while start < n:
        end = min(start + chunk_size, n)
        brk = np.flatnonzero(sigmas[start:end] != sigmas[start])
        if brk.size:
            end = start + int(brk[0])
        spans.append((start, end))
        start = end
    return spans


def grid_fingerprint(cfg, grid, keep_history: str,
                     migrate: dict | None = None) -> str:
    """Identity of (problem, grid, history mode) pinned by the results
    manifest: the hex digest ``repro.core.sweep.grid_fingerprint`` gives
    for the same grid run with ``backend="jnp"`` (the reference hashes
    "full"/"none" as the bools they once were).  Sampled grids add the
    evaluation mode and the sample stream's identity, and, only when
    certification is on, its budget; exhaustive grids add nothing, so their
    fingerprints do not depend on those knobs.  ``migrate`` holds the
    migration knobs when migration is on (it changes results, and its
    epochs follow the plan and the pods); ``None`` leaves the digest
    unchanged."""
    ecfg = cfg.evolve
    ident = {
        "width": cfg.width, "kind": cfg.kind, "n_n": cfg.n_n,
        "generations": ecfg.generations, "lam": ecfg.lam,
        "mutation_rate": ecfg.mutation_rate, "backend": _REFERENCE_BACKEND,
        "migrate_every": ecfg.migrate_every,
        "keep_history": {"full": True, "none": False}.get(keep_history,
                                                         keep_history),
        "grid": [(con.describe(), con.gauss_sigma, seed)
                 for con, seed in grid],
        "thresholds": hashlib.sha256(
            np.stack([con.thresholds() for con, _ in grid]).tobytes()
        ).hexdigest(),
    }
    if ecfg.eval_mode != "exhaustive":
        ident["eval_mode"] = ecfg.eval_mode
        ident["sample_stream"] = sampling.stream_fingerprint(
            cfg.width, ecfg.sample_size, ecfg.input_dist, ecfg.sample_seed)
        if ecfg.certify:
            ident["certify"] = {"budget": int(ecfg.certify_budget)}
    if migrate:
        ident["migrate"] = migrate
    return hashlib.sha256(json.dumps(ident, sort_keys=True,
                                     default=float).encode()).hexdigest()


def _alloc_buffers(spec: CGPSpec, n_runs: int, gens: int,
                   keep_history: str) -> dict[str, np.ndarray]:
    """Grid-order host buffers under the reference's keys and dtypes (a
    checkpoint holds exactly these, its leaves in sorted-key order);
    ``hist_*`` only in "full" mode."""
    bufs = {
        "parent_nodes": np.zeros((n_runs, spec.n_n, 3), np.int32),
        "parent_outs": np.zeros((n_runs, spec.n_o), np.int32),
        "best_nodes": np.zeros((n_runs, spec.n_n, 3), np.int32),
        "best_outs": np.zeros((n_runs, spec.n_o), np.int32),
        "best_fit": np.zeros((n_runs,), np.float32),
        "metrics": np.zeros((n_runs, M.N_METRICS), np.float32),
        "metrics_stderr": np.zeros((n_runs, M.N_METRICS), np.float32),
        "power_rel": np.zeros((n_runs,), np.float32),
        "feasible": np.zeros((n_runs,), np.uint8),
        "certified_mask": np.zeros((n_runs,), np.uint8),
        "error_mean": np.zeros((n_runs,), np.float32),
        "error_std": np.zeros((n_runs,), np.float32),
    }
    if keep_history == "full":
        bufs["hist_power_rel"] = np.zeros((n_runs, gens), np.float32)
        bufs["hist_fit"] = np.zeros((n_runs, gens), np.float32)
        bufs["hist_metrics"] = np.zeros((n_runs, gens, M.N_METRICS),
                                        np.float32)
    return bufs


def _try_resume(ckpt_dir: str, bufs: dict, fingerprint: str) -> int:
    """Load the newest committed step OF THIS GRID into ``bufs`` in place;
    returns the runs it holds (a prefix of the execution order).  Steps are
    scanned newest first by fingerprint, so another grid's checkpoint in the
    same directory cannot shadow this grid's."""
    for step in reversed(store.committed_steps(ckpt_dir)):
        if store.load_metadata(ckpt_dir, step).get("fingerprint") \
                != fingerprint:
            continue
        tree, meta = store.load_checkpoint(ckpt_dir, step, bufs)
        for k, v in tree.items():
            bufs[k][...] = v
        return int(meta["done"])
    return 0


def _agree_opened(err: BaseException | None, dev) -> None:
    """A barrier of the world after the writing rank opened (and maybe
    restored and quarantined) the results directory: every rank reads the
    directory only after it.  A failure on any rank raises on every rank,
    instead of leaving the others in the sweep's first collective."""
    failed = torch.tensor([err is not None], dtype=torch.int32, device=dev)
    dist.all_reduce(failed)
    if err is not None:
        raise err
    if failed.item():
        raise RuntimeError("another rank failed to open the results "
                           "directory")


def run_sweep_batched(cfg, constraints: Sequence[ConstraintSpec],
                      seeds: Sequence[int] = (0,),
                      sweep: SweepConfig | None = None,
                      device: torch.device | str | None = None
                      ) -> SweepResult:
    """Execute the constraint×seed grid with the batched engine.

    ``cfg`` is a ``search.SearchConfig``; per-run results match the serial
    ``run_search`` path (same PRNG streams, same evaluation semantics).
    Runs on ``device`` (default: the card; under ``sweep.model_axis``, the
    mesh's device).  With ``sweep.results_dir`` every finished chunk is
    committed as one shard (``core.results``) and the committed shards are
    the resume state; otherwise resume goes through ``sweep.checkpoint_dir``.

    With ``sweep.n_pods > 1`` this call runs ONE pod's slice of the chunk
    plan against the shared ``results_dir``; the result covers everything
    committed so far (this pod's chunks and the other pods' restored
    shards), ``done_mask`` marking the covered rows.

    Under ``sweep.model_axis`` every rank must skip the same chunks, or the
    ranks' collectives fall out of step: the writing rank restores (and
    quarantines), every rank passes a barrier, and the other ranks then
    scatter the same committed shards read-only, or load the same
    checkpoint step (only the writing rank commits).
    """
    sweep = sweep or SweepConfig()
    mode = sweep.keep_history
    grid = sweep_grid(constraints, seeds)
    n_runs = len(grid)
    gens = cfg.evolve.generations
    dedup = sweep.dedup if sweep.dedup is not None else cfg.evolve.dedup
    if dedup and sweep.model_axis is not None:
        # refused before the mesh check: it holds with or without a mesh
        raise ValueError(
            "dedup is incompatible with model_axis: the dedup generation "
            "loop decides on the host between launches, a cube-sharded "
            "chunk is one collective program")
    group, writes = None, True
    if sweep.model_axis is not None:
        mesh = ctx.get_mesh()
        if mesh is None or sweep.model_axis not in mesh.axis_names:
            raise ValueError(
                f"model_axis {sweep.model_axis!r} needs an active "
                f"parallel.ctx mesh carrying that axis (have: "
                f"{None if mesh is None else mesh.axis_names})")
        group = mesh.axis_group(sweep.model_axis)
        # one writing rank a pod: coordinate 0 on every axis but the pods'
        writes = not any(c for axis, c in mesh.coords.items()
                         if axis != "pod")
        device = mesh.device if device is None else device
    gold, spec, in_planes, gvals, gpower = problem_arrays(cfg, device)
    dev = in_planes.device
    planes_local, gvals_local = in_planes, gvals
    if group is not None:
        n, i = mesh.axis_size(sweep.model_axis), \
            mesh.axis_index(sweep.model_axis)
        W = in_planes.shape[1]
        if W % n:
            raise ValueError(f"the cube's {W} words do not split over the "
                             f"{n} ranks of axis {sweep.model_axis!r}")
        lo, hi = i * W // n, (i + 1) * W // n
        planes_local = in_planes[:, lo:hi].contiguous()
        gvals_local = gvals[32 * lo:32 * hi].contiguous()

    thr = np.stack([con.thresholds() for con, _ in grid])
    keys = torch.stack([R.PRNGKey(s) for _, s in grid])
    sigmas = np.array([con.gauss_sigma for con, _ in grid])
    perm = np.argsort(sigmas, kind="stable")
    chunks = plan_chunks(sigmas[perm], sweep.chunk_size)
    pod = sweep.pod_index
    if pod is None:
        pod = ctx.default_pod_index(sweep.n_pods) if sweep.n_pods > 1 else 0

    sampled = cfg.evolve.eval_mode == "sampled"
    # a cache entry names the inputs it was measured on: sampled grids add
    # the sample stream to (grid fingerprint, σ)
    sample_scope: tuple = ()
    if sampled:
        sample_scope = (sampling.stream_fingerprint(
            cfg.width, cfg.evolve.sample_size, cfg.evolve.input_dist,
            cfg.evolve.sample_seed),)
    cache = PhenotypeLRU(sweep.dedup_cache_size) if dedup else None
    # the exact tier runs for sampled grids only: an exhaustive census is
    # already exact, so its rows are certified without escalation
    certify_on = sampled and cfg.evolve.certify
    # the exact pass's slice is the module's DISPATCH_ROWS at call time
    policy = (certify.CertifyPolicy(
        budget=cfg.evolve.certify_budget,
        dispatch_rows=certify.DISPATCH_ROWS) if certify_on else None)
    # a span's budget follows its place in the FULL plan (not this pod's
    # slice), so pods and resumed sweeps budget identically
    plan_pos = {span: i for i, span in enumerate(chunks)}
    n_escalated = 0

    bufs = _alloc_buffers(spec, n_runs, gens, mode)
    migrating = sweep.migrate_every > 0
    fingerprint = grid_fingerprint(
        cfg, grid, mode,
        migrate={"every": sweep.migrate_every, "n_pods": sweep.n_pods,
                 "chunk_size": sweep.chunk_size,
                 "top_k": migrate_mod.MIGRATE_TOP_K} if migrating else None)
    exec_done = np.zeros(n_runs, bool)  # execution-order positions covered
    writer = None
    if sweep.results_dir:
        restored, err = [], None
        if writes:
            try:
                writer = SweepResultWriter(
                    sweep.results_dir, grid_fingerprint=fingerprint,
                    grid_meta=[{"constraint": con.describe(), "seed": seed,
                                "gauss_sigma": con.gauss_sigma}
                               for con, seed in grid],
                    n_runs=n_runs, gens=gens, n_n=spec.n_n, n_o=spec.n_o,
                    keep_history=mode, chunk_size=sweep.chunk_size,
                    chunk_spans=chunks, n_pods=sweep.n_pods,
                    problem_meta={"width": cfg.width, "kind": cfg.kind,
                                  "n_n": spec.n_n})
                # shards commit every chunk (checkpoints only every
                # checkpoint_every): the freshest resume state
                restored = writer.restore(bufs)
            except Exception as e:
                if group is None:
                    raise
                err = e
        if group is not None:
            _agree_opened(err, dev)
            if writer is None:
                restored = SweepResultReader(sweep.results_dir).restore(bufs)
        for s, e in restored:
            exec_done[s:e] = True
    elif sweep.checkpoint_dir:
        exec_done[:_try_resume(sweep.checkpoint_dir, bufs, fingerprint)] = \
            True
    # the manifest pins the plan, and with it the pod partition
    my_chunks = (writer.pod_spans(pod) if writer is not None
                 else pod_partition(chunks, sweep.n_pods)[pod])

    # chunk-level migration: the publish/import schedule follows the plan
    # alone, so every pod derives the same one with no coordination
    migrator = None
    if migrating:
        migrator = migrate_mod.MigrationManager(
            sweep.results_dir, pod,
            [len(p) for p in pod_partition(chunks, sweep.n_pods)],
            sweep.migrate_every, fingerprint, timeout=sweep.migrate_timeout)
        mig_evals: dict[tuple, tuple | None] = {}

        def publish_epoch(epoch: int) -> None:
            # from the committed grid-order rows of the epoch's spans: the
            # same whether they ran now or were restored, so a resume
            # republishes the same bytes
            spans = my_chunks[epoch * sweep.migrate_every:
                              (epoch + 1) * sweep.migrate_every]
            rows = np.concatenate([perm[s:e] for s, e in spans])
            migrator.maybe_publish(epoch, migrate_mod.select_elites(
                bufs["parent_nodes"][rows], bufs["parent_outs"][rows],
                bufs["power_rel"][rows],
                bufs["feasible"][rows].astype(bool), sigmas[rows], spec))

        def migrant_batch(epoch: int, sigma: float, ecfg):
            # one import and one launch per (epoch, σ); migrants padded to
            # a power-of-two bucket by repeating row 0 AFTER the real rows
            mkey = (epoch, float(sigma))
            if mkey not in mig_evals:
                cand = migrator.candidates(epoch, sigma)
                if cand is None:
                    mig_evals[mkey] = None
                else:
                    m = len(cand[0])
                    pad = np.r_[np.arange(m),
                                np.zeros((1 << (m - 1).bit_length()) - m,
                                         np.int64)]
                    mn = torch.as_tensor(cand[0][pad], device=dev)
                    mo = torch.as_tensor(cand[1][pad], device=dev)
                    mig_evals[mkey] = (mn, mo) + eval_segment(
                        spec, ecfg, mn, mo, in_planes, gvals)
            return mig_evals[mkey]

    # background commits: the next chunk runs while this one's shard is
    # written; the same bytes in the same order
    committer = (ChunkCommitter(sweep.commit_depth) if sweep.async_commit
                 and (writer is not None or sweep.checkpoint_dir and writes)
                 else None)

    def commit_checkpoint(tree: dict, done: int) -> None:
        store.save_checkpoint(sweep.checkpoint_dir, done, tree,
                              {"done": done, "fingerprint": fingerprint})
        store.cleanup(sweep.checkpoint_dir, keep=3)

    t0 = time.perf_counter()
    ran = chunks_run = 0
    try:
        for pos, (start, end) in enumerate(my_chunks):
            if exec_done[start:end].all():
                # committed by an earlier call; an epoch whose chunks were
                # all restored may still owe its migrant file (a stop
                # between the last shard commit and the publish)
                if migrator is not None and \
                        migrator.publishes_at(pos) is not None:
                    publish_epoch(migrator.publishes_at(pos))
                continue
            if sweep.max_chunks is not None and \
                    chunks_run >= sweep.max_chunks:
                break
            n = end - start
            sel = perm[np.r_[start:end,
                             np.full(sweep.chunk_size - n, end - 1)]]
            orig = sel[:n]  # grid-order rows this chunk fills
            sigma = float(sigmas[orig[0]])
            ecfg = dataclasses.replace(cfg.evolve, gauss_sigma=sigma)
            if sweep.layout is not None:
                ecfg = dataclasses.replace(ecfg, layout=sweep.layout)
            thr_c = torch.as_tensor(thr[sel], device=dev)
            keys_c = keys[torch.from_numpy(sel)].to(dev)

            state0 = None
            if migrator is not None:
                # every chunk of a migrating sweep starts from an explicit
                # state, folded with the previous epoch's migrants
                state0 = init_state_batched(spec, ecfg, gold, thr_c,
                                            in_planes, gvals, keys_c)
                ep = migrator.epoch_of(pos)
                batch = migrant_batch(ep - 1, sigma, ecfg) if ep else None
                if batch is not None:
                    state0, adopted = migrate_mod.fold_segment(
                        state0, *batch, thr_c)
                    migrator.stats["adopted"] += adopted

            step = (dedup_generation_step(
                spec, ecfg, cache, (fingerprint, sigma) + sample_scope)
                if dedup else None)
            state, hp, hm, hf = evolve_chunk(
                spec, ecfg, gold, thr_c, planes_local, gvals_local, gpower,
                keys_c, group, state0=state0, step=step)
            met, sterr, prel, ok, emean, estd = characterize_chunk(
                spec, sigma, state.parent.nodes, state.parent.outs, thr_c,
                in_planes, gvals, gpower, sampled=sampled)
            host = lambda x: x.cpu().numpy()[:n]
            nodes_np = host(state.parent.nodes)
            outs_np = host(state.parent.outs)
            met_np, sterr_np = host(met).copy(), host(sterr).copy()
            feas_np = host(ok).astype(np.uint8)
            prel_np = host(prel)
            # a census is its own certificate; sampled rows are certified
            # only by the exact tier
            cert = np.full(n, 0 if sampled else 1, np.uint8)
            if certify_on:
                # the best sampled-feasible elites, re-measured over the cube
                rows = certify.select_escalations(
                    feas_np, prel_np, cert,
                    policy.chunk_budget(plan_pos[(start, end)], len(chunks)))
                if rows.size:
                    exact = certify.certified_metrics_batched(
                        nodes_np[rows], outs_np[rows], spec, cfg.kind,
                        cfg.width, sigma, dispatch_rows=policy.dispatch_rows,
                        device=dev)
                    for r, cmet in zip(rows, exact):
                        met_np[r] = cmet
                        sterr_np[r] = 0.0      # no sampling error left
                        feas_np[r] = certify.feasible_np(cmet, thr[orig[r]])
                        cert[r] = 1
                    n_escalated += rows.size
            chunk_rows = {
                "parent_nodes": nodes_np,
                "parent_outs": outs_np,
                "best_nodes": host(state.best.nodes),
                "best_outs": host(state.best.outs),
                "best_fit": host(state.best_fit),
                "metrics": met_np,
                "metrics_stderr": sterr_np,
                "power_rel": prel_np,
                "feasible": feas_np,
                "certified_mask": cert,
                "error_mean": host(emean),
                "error_std": host(estd),
            }
            for key, rows in chunk_rows.items():
                bufs[key][orig] = rows
            if mode == "full":
                bufs["hist_power_rel"][orig] = host(hp)
                bufs["hist_fit"][orig] = host(hf)
                bufs["hist_metrics"][orig] = host(hm)
            if writer is not None:
                chunk_rows["grid_rows"] = orig.astype(np.int32)
                chunk_rows["thresholds"] = thr[orig]
                if mode != "none":
                    chunk_rows.update(hist_power_rel=host(hp),
                                      hist_fit=host(hf), hist_metrics=host(hm))
                if committer is not None:
                    # host arrays built for this chunk and never changed
                    # after this point: safe to hand over uncopied
                    committer.submit(writer.write_chunk, (start, end),
                                     chunk_rows)
                else:
                    writer.write_chunk((start, end), chunk_rows)
            exec_done[start:end] = True
            ran += n
            chunks_run += 1
            if migrator is not None and \
                    migrator.publishes_at(pos) is not None:
                publish_epoch(migrator.publishes_at(pos))
            if sweep.checkpoint_dir and writes and (
                    chunks_run % sweep.checkpoint_every == 0
                    or exec_done.all()):
                # one pod: chunks run in plan order, so the coverage is a
                # prefix, whose length is the step
                done = n_runs if exec_done.all() else int(np.argmin(exec_done))
                if committer is not None:
                    # a snapshot: the loop goes on writing into bufs
                    committer.submit(commit_checkpoint,
                                     {k: v.copy() for k, v in bufs.items()},
                                     done)
                else:
                    commit_checkpoint(bufs, done)
    except BaseException:
        # drain the handed-over commits while unwinding (KeyboardInterrupt
        # included), without masking the exception in flight
        if committer is not None:
            committer.close(raise_errors=False)
        raise
    if committer is not None:
        committer.close()
    if group is not None and (sweep.results_dir or sweep.checkpoint_dir):
        # no rank returns before the writing rank's commits are there
        dist.all_reduce(torch.zeros(1, device=dev))
    dt = time.perf_counter() - t0

    done_mask = np.zeros(n_runs, bool)
    done_mask[perm[exec_done]] = True
    records = [CircuitRecord(
        genome_nodes=bufs["parent_nodes"][i],
        genome_outs=bufs["parent_outs"][i], metrics=bufs["metrics"][i],
        power_rel=float(bufs["power_rel"][i]),
        constraint=grid[i][0].describe(), seed=grid[i][1],
        feasible=bool(bufs["feasible"][i]),
        error_mean=float(bufs["error_mean"][i]),
        error_std=float(bufs["error_std"][i]),
        metrics_stderr=bufs["metrics_stderr"][i],
        certified=bool(bufs["certified_mask"][i]))
        for i in np.flatnonzero(done_mask)]
    return SweepResult(
        records=records, thresholds=thr, metrics=bufs["metrics"],
        metrics_stderr=bufs["metrics_stderr"],
        power_rel=bufs["power_rel"], feasible=bufs["feasible"].astype(bool),
        best_fit=bufs["best_fit"],
        hist_power_rel=bufs.get("hist_power_rel"),
        hist_fit=bufs.get("hist_fit"),
        hist_metrics=bufs.get("hist_metrics"),
        done_mask=done_mask, completed=int(exec_done.sum()), n_runs=n_runs,
        runs_per_sec=(ran / dt) if ran else 0.0,
        results_dir=sweep.results_dir,
        certified_mask=bufs["certified_mask"].astype(bool),
        certify_stats=({
            "escalated": n_escalated,
            "certified_rows": int(bufs["certified_mask"].sum()),
            "budget": int(cfg.evolve.certify_budget),
        } if certify_on else None),
        dedup_stats=cache.stats.as_dict() if cache is not None else None,
        migrate_stats=dict(migrator.stats) if migrator is not None else None)
