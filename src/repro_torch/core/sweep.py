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
package computes for the same exhaustive grid, so either package's reader
opens the other's directory.

``SweepConfig.model_axis`` shards every evaluation's input cube over that
axis of the active ``parallel.ctx`` mesh: each rank of the axis simulates
its word slice, the partials are all-reduced (``ops.cgp_eval_batched``
with a process group), and per-run state, thresholds and keys are
replicated, so every rank mutates and selects the same way and returns the
same ``SweepResult``.  Only the rank at coordinate 0 of every mesh axis
writes the result shards.
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
from repro_torch.core import metrics as M
from repro_torch.core import simulate
from repro_torch.core.evolve import (EvolveConfig, init_state_batched,
                                     make_batched_generation_step,
                                     scan_generations)
from repro_torch.core.fitness import ConstraintSpec, feasible
from repro_torch.core.genome import CGPSpec, Genome
from repro_torch.core.power import circuit_cost_from_probs
from repro_torch.core.results import HISTORY_MODES, SweepResultWriter
from repro_torch.core.search import CircuitRecord, problem_arrays
from repro_torch.parallel import ctx

# The field of the reference's EvolveConfig that its grid fingerprint
# hashes and the port has no knob for: exhaustive evaluation is the port's
# only (jnp-equivalent) backend.
_REFERENCE_BACKEND = "jnp"


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Execution knobs of the batched sweep.

    ``keep_history``: ``"full"`` keeps the per-generation parent histories
    on the returned ``SweepResult`` (``hist_*``, ``(n_runs, gens, ...)``)
    and, with a ``results_dir``, in the shards too; ``"summary"`` writes
    them to the ``results_dir`` shards only (read them back with
    ``SweepResultReader.iter_history``; without a ``results_dir`` they are
    dropped); ``"none"`` keeps them nowhere.  ``results_dir`` streams one
    shard per chunk (``core.results``).  ``max_chunks`` stops after that
    many chunks.  ``layout`` overrides ``cfg.evolve.layout`` (the cgp_sim
    kernel variant: ``"auto"``, ``"genome_major"``, ``"cube_major"``) for
    every chunk of this sweep; ``None`` defers to it.  The runs are the same
    under every layout, and the grid fingerprint leaves it out.

    ``model_axis`` names an axis of the ACTIVE ``parallel.ctx`` mesh to
    shard every evaluation's input cube over (module docstring); the sweep
    refuses to run without such a mesh.  Selection under MAE/WCE/ER/AVG/
    ACC0 constraints is the unsharded sweep's (integer-exact partials); the
    MRE sums are reassociated, so MRE-constrained runs may split at a
    last-bit tie.  Like ``layout`` it stays out of the grid fingerprint.
    """
    chunk_size: int = 32          # runs per chunk (device-memory bound)
    keep_history: str = "full"
    results_dir: str | None = None
    max_chunks: int | None = None
    layout: str | None = None
    model_axis: str | None = None  # mesh axis to shard the input cube over

    def __post_init__(self):
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")
        if self.keep_history not in HISTORY_MODES:
            raise ValueError(f"keep_history must be one of {HISTORY_MODES}, "
                             f"got {self.keep_history!r}")
        if self.layout not in (None, "auto", "genome_major", "cube_major"):
            raise ValueError(
                f"layout must be None, 'auto', 'genome_major' or "
                f"'cube_major', got {self.layout!r}")


@dataclasses.dataclass
class SweepResult:
    """Stacked output of a (possibly partial) grid sweep.

    Run-major arrays are in grid order (constraints outer, seeds inner);
    ``done_mask`` marks the completed rows and ``records`` holds exactly the
    completed runs, in grid order.  ``hist_*`` are set only with
    ``keep_history="full"``.
    """
    records: list                      # list[CircuitRecord]
    thresholds: np.ndarray             # (n_runs, N_METRICS)
    metrics: np.ndarray                # (n_runs, N_METRICS) final measurement
    power_rel: np.ndarray              # (n_runs,)
    feasible: np.ndarray               # (n_runs,) bool
    best_fit: np.ndarray               # (n_runs,)
    hist_power_rel: np.ndarray | None  # (n_runs, gens)
    hist_fit: np.ndarray | None        # (n_runs, gens)
    hist_metrics: np.ndarray | None    # (n_runs, gens, N_METRICS)
    done_mask: np.ndarray              # (n_runs,) bool
    completed: int
    n_runs: int
    runs_per_sec: float
    results_dir: str | None = None     # where the shards went, if streaming

    def reader(self):
        """The ``SweepResultReader`` of this sweep's ``results_dir``."""
        from repro_torch.core.results import SweepResultReader
        if self.results_dir is None:
            raise ValueError("sweep ran without results_dir: no shards")
        return SweepResultReader(self.results_dir)


def evolve_chunk(spec: CGPSpec, cfg: EvolveConfig, golden: Genome,
                 thr_mat: torch.Tensor, in_planes: torch.Tensor,
                 golden_vals: torch.Tensor, golden_power: torch.Tensor,
                 keys: torch.Tensor, group=None):
    """Evolve ``thr_mat.shape[0]`` runs together: one kernel launch for the
    golden parent, then one per generation.  Histories come back run-major:
    (state, power_rel (C, gens), metrics (C, gens, N_METRICS),
    fitness (C, gens)).  With ``group``, ``in_planes``/``golden_vals`` are
    this rank's slice of the cube and every launch is sharded over the
    group's ranks; everything else is replicated, and so is the result."""
    step = make_batched_generation_step(spec, cfg, group)
    state0 = init_state_batched(spec, cfg, golden, thr_mat, in_planes,
                                golden_vals, keys, group)
    state, (hp, hm, hf) = scan_generations(step, state0, thr_mat, in_planes,
                                           golden_vals, golden_power,
                                           cfg.generations)
    return state, hp.T, hm.transpose(0, 1), hf.T


def characterize_chunk(spec: CGPSpec, gauss_sigma: float, nodes: torch.Tensor,
                       outs: torch.Tensor, thr_mat: torch.Tensor,
                       in_planes: torch.Tensor, golden_vals: torch.Tensor,
                       golden_power: torch.Tensor):
    """Final measurement of C circuits (plain tensor code on the device):
    (metrics (C, N_METRICS), power_rel (C,), feasible (C,), error mean (C,),
    error std (C,))."""
    g = Genome(nodes, outs)
    wires = simulate.simulate_planes(g, spec, in_planes)
    cvals = simulate.unpack_values(simulate.output_planes(g, wires))
    partials = M.error_partials(golden_vals, cvals, gauss_sigma,
                                n_bits=spec.n_o)
    met = M.finalize_metrics(partials, spec.n_o, gauss_sigma)
    probs = simulate.signal_probabilities(wires[:, spec.n_i:])
    cost = circuit_cost_from_probs(g, spec, probs, with_delay=False)
    emean, estd = M.error_moments(golden_vals, cvals)
    return (met, cost.power / golden_power, feasible(met, thr_mat), emean,
            estd)


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


def grid_fingerprint(cfg, grid, keep_history: str) -> str:
    """Identity of (problem, grid, history mode) pinned by the results
    manifest: the hex digest ``repro.core.sweep.grid_fingerprint`` gives
    for the same exhaustive grid run with ``backend="jnp"`` and no
    chunk-level migration (the reference hashes "full"/"none" as the bools
    they once were)."""
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
    return hashlib.sha256(json.dumps(ident, sort_keys=True,
                                     default=float).encode()).hexdigest()


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
    committed as one shard (``core.results``).
    """
    sweep = sweep or SweepConfig()
    mode = sweep.keep_history
    grid = sweep_grid(constraints, seeds)
    n_runs = len(grid)
    gens = cfg.evolve.generations
    group, writes = None, True
    if sweep.model_axis is not None:
        mesh = ctx.get_mesh()
        if mesh is None or sweep.model_axis not in mesh.axis_names:
            raise ValueError(
                f"model_axis {sweep.model_axis!r} needs an active "
                f"parallel.ctx mesh carrying that axis (have: "
                f"{None if mesh is None else mesh.axis_names})")
        group = mesh.axis_group(sweep.model_axis)
        writes = not any(mesh.coords.values())
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

    writer = None
    if sweep.results_dir and writes:
        writer = SweepResultWriter(
            sweep.results_dir,
            grid_fingerprint=grid_fingerprint(cfg, grid, mode),
            grid_meta=[{"constraint": con.describe(), "seed": seed,
                        "gauss_sigma": con.gauss_sigma}
                       for con, seed in grid],
            n_runs=n_runs, gens=gens, n_n=spec.n_n, n_o=spec.n_o,
            keep_history=mode, chunk_size=sweep.chunk_size,
            chunk_spans=chunks,
            problem_meta={"width": cfg.width, "kind": cfg.kind,
                          "n_n": spec.n_n})

    metrics = np.zeros((n_runs, M.N_METRICS), np.float32)
    power_rel = np.zeros((n_runs,), np.float32)
    feas = np.zeros((n_runs,), bool)
    best_fit = np.zeros((n_runs,), np.float32)
    nodes = np.zeros((n_runs, spec.n_n, 3), np.int32)
    outs = np.zeros((n_runs, spec.n_o), np.int32)
    moments = np.zeros((n_runs, 2), np.float32)
    full = mode == "full"
    if full:
        hist_p = np.zeros((n_runs, gens), np.float32)
        hist_f = np.zeros((n_runs, gens), np.float32)
        hist_m = np.zeros((n_runs, gens, M.N_METRICS), np.float32)
    done = np.zeros(n_runs, bool)

    t0 = time.perf_counter()
    ran = 0
    for start, end in chunks[:sweep.max_chunks]:
        n = end - start
        sel = perm[np.r_[start:end, np.full(sweep.chunk_size - n, end - 1)]]
        orig = sel[:n]  # grid-order rows this chunk fills
        sigma = float(sigmas[orig[0]])
        ecfg = dataclasses.replace(cfg.evolve, gauss_sigma=sigma)
        if sweep.layout is not None:
            ecfg = dataclasses.replace(ecfg, layout=sweep.layout)
        thr_c = torch.as_tensor(thr[sel], device=dev)
        state, hp, hm, hf = evolve_chunk(spec, ecfg, gold, thr_c,
                                         planes_local, gvals_local, gpower,
                                         keys[torch.from_numpy(sel)].to(dev),
                                         group)
        met, prel, ok, emean, estd = characterize_chunk(
            spec, sigma, state.parent.nodes, state.parent.outs, thr_c,
            in_planes, gvals, gpower)
        host = lambda x: x.cpu().numpy()[:n]
        metrics[orig] = host(met)
        power_rel[orig] = host(prel)
        feas[orig] = host(ok)
        best_fit[orig] = host(state.best_fit)
        nodes[orig] = host(state.parent.nodes)
        outs[orig] = host(state.parent.outs)
        moments[orig] = host(torch.stack([emean, estd], dim=1))
        if full:
            hist_p[orig], hist_f[orig], hist_m[orig] = (
                host(hp), host(hf), host(hm))
        if writer is not None:
            rows = {
                "grid_rows": orig.astype(np.int32),
                "thresholds": thr[orig],
                "parent_nodes": nodes[orig], "parent_outs": outs[orig],
                "best_nodes": host(state.best.nodes),
                "best_outs": host(state.best.outs),
                "best_fit": best_fit[orig], "metrics": metrics[orig],
                "metrics_stderr": np.zeros((n, M.N_METRICS), np.float32),
                "power_rel": power_rel[orig],
                "feasible": feas[orig].astype(np.uint8),
                "certified_mask": np.ones(n, np.uint8),  # a census is exact
                "error_mean": moments[orig, 0],
                "error_std": moments[orig, 1],
            }
            if mode != "none":
                rows.update(hist_power_rel=host(hp), hist_fit=host(hf),
                            hist_metrics=host(hm))
            writer.write_chunk((start, end), rows)
        done[orig] = True
        ran += n
    if group is not None and sweep.results_dir:
        # no rank returns before the writing rank's shards are there
        dist.all_reduce(torch.zeros(1, device=dev))
    dt = time.perf_counter() - t0

    records = [CircuitRecord(
        genome_nodes=nodes[i], genome_outs=outs[i], metrics=metrics[i],
        power_rel=float(power_rel[i]), constraint=grid[i][0].describe(),
        seed=grid[i][1], feasible=bool(feas[i]),
        error_mean=float(moments[i, 0]), error_std=float(moments[i, 1]))
        for i in np.flatnonzero(done)]
    return SweepResult(
        records=records, thresholds=thr, metrics=metrics,
        power_rel=power_rel, feasible=feas, best_fit=best_fit,
        hist_power_rel=hist_p if full else None,
        hist_fit=hist_f if full else None,
        hist_metrics=hist_m if full else None,
        done_mask=done, completed=int(done.sum()), n_runs=n_runs,
        runs_per_sec=(ran / dt) if ran else 0.0,
        results_dir=sweep.results_dir)
