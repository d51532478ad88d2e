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
writes the result shards and checkpoints.
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
from repro_torch.core import pareto, sampling, simulate
from repro_torch.core.evolve import (EvolveConfig, init_state_batched,
                                     make_batched_generation_step,
                                     scan_generations)
from repro_torch.core.fitness import ConstraintSpec, feasible
from repro_torch.core.genome import CGPSpec, Genome
from repro_torch.core.power import circuit_cost_from_probs
from repro_torch.core.results import (HISTORY_MODES, SweepResultReader,
                                      SweepResultWriter)
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
    """
    chunk_size: int = 32          # runs per chunk (device-memory bound)
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1     # chunks between checkpoint commits
    keep_history: str = "full"
    results_dir: str | None = None
    max_chunks: int | None = None  # chunks this call runs, at most
    layout: str | None = None
    model_axis: str | None = None  # mesh axis to shard the input cube over

    def __post_init__(self):
        if self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")
        if self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {self.checkpoint_every}")
        if self.layout not in (None, "auto", "genome_major", "cube_major"):
            raise ValueError(
                f"layout must be None, 'auto', 'genome_major' or "
                f"'cube_major', got {self.layout!r}")
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


def grid_fingerprint(cfg, grid, keep_history: str) -> str:
    """Identity of (problem, grid, history mode) pinned by the results
    manifest: the hex digest ``repro.core.sweep.grid_fingerprint`` gives
    for the same grid run with ``backend="jnp"`` and no chunk-level
    migration (the reference hashes "full"/"none" as the bools they once
    were).  Sampled grids add the evaluation mode and the sample stream's
    identity, and, only when certification is on, its budget; exhaustive
    grids add nothing, so their fingerprints do not depend on those
    knobs."""
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

    Under ``sweep.model_axis`` every rank must skip the same chunks, or the
    ranks' collectives fall out of step: the writing rank restores (and
    quarantines), every rank passes a barrier, and the other ranks then
    scatter the same committed shards read-only, or load the same
    checkpoint step (only the writing rank commits checkpoints).
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

    sampled = cfg.evolve.eval_mode == "sampled"
    # the exact tier runs for sampled grids only: an exhaustive census is
    # already exact, so its rows are certified without escalation
    certify_on = sampled and cfg.evolve.certify
    # the exact pass's slice is the module's DISPATCH_ROWS at call time
    policy = (certify.CertifyPolicy(
        budget=cfg.evolve.certify_budget,
        dispatch_rows=certify.DISPATCH_ROWS) if certify_on else None)
    # a span's budget follows its place in the FULL plan, so resumed sweeps
    # budget identically
    plan_pos = {span: i for i, span in enumerate(chunks)}
    n_escalated = 0

    bufs = _alloc_buffers(spec, n_runs, gens, mode)
    fingerprint = grid_fingerprint(cfg, grid, mode)
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
                    chunk_spans=chunks,
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

    t0 = time.perf_counter()
    ran = chunks_run = 0
    for start, end in chunks:
        if exec_done[start:end].all():
            continue               # committed by an earlier call
        if sweep.max_chunks is not None and chunks_run >= sweep.max_chunks:
            break
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
        met, sterr, prel, ok, emean, estd = characterize_chunk(
            spec, sigma, state.parent.nodes, state.parent.outs, thr_c,
            in_planes, gvals, gpower, sampled=sampled)
        host = lambda x: x.cpu().numpy()[:n]
        nodes_np, outs_np = host(state.parent.nodes), host(state.parent.outs)
        met_np, sterr_np = host(met).copy(), host(sterr).copy()
        feas_np = host(ok).astype(np.uint8)
        prel_np = host(prel)
        # a census is its own certificate; sampled rows are certified only
        # by the exact tier
        cert = np.full(n, 0 if sampled else 1, np.uint8)
        if certify_on:
            # the best sampled-feasible elites, re-measured over the cube
            rows = certify.select_escalations(
                feas_np, prel_np, cert,
                policy.chunk_budget(plan_pos[(start, end)], len(chunks)))
            if rows.size:
                exact = certify.certified_metrics_batched(
                    nodes_np[rows], outs_np[rows], spec, cfg.kind, cfg.width,
                    sigma, dispatch_rows=policy.dispatch_rows, device=dev)
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
                chunk_rows.update(hist_power_rel=host(hp), hist_fit=host(hf),
                                  hist_metrics=host(hm))
            writer.write_chunk((start, end), chunk_rows)
        exec_done[start:end] = True
        ran += n
        chunks_run += 1
        if sweep.checkpoint_dir and writes and (
                chunks_run % sweep.checkpoint_every == 0 or exec_done.all()):
            # chunks run in plan order, so the coverage is a prefix, whose
            # length is the step
            done = n_runs if exec_done.all() else int(np.argmin(exec_done))
            store.save_checkpoint(sweep.checkpoint_dir, done, bufs,
                                  {"done": done, "fingerprint": fingerprint})
            store.cleanup(sweep.checkpoint_dir, keep=3)
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
        } if certify_on else None))
