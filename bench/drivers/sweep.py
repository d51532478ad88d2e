"""Driver of the (1+λ) CGP sweep: one chunk of C runs stepped generation by
generation through the program's ``make_batched_generation_step``.

Set-up builds the chunk from the seed (each run's key; the thresholds
dealt round-robin over the mix's constraints) and the configuration's
golden circuit, evaluates the golden parent (``init_state_batched``) and
steps a few warm-up generations.  The window then steps until
``--seconds`` have passed; a chunk whose runs reach the mix's
``generations`` is followed by the next chunk from its own keys, as a
sweep goes on.  ``runs_per_s`` is the runs' generations completed over
the generations a run takes, over the window.

The check samples runs from the seed and has ``reference.sweep.judge``
work out their last generation from the state before it.

A traced run steps ``trace_generations`` under the profiler (segments
labelled, each ``cgp_sim`` launch's genomes kept for the work model),
then as many with each segment synchronised and timed.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import harness as H
from bench import seeds
from bench.reference import circuit as C
from bench.reference import sweep as J
from bench.workmodels import cgp_sim as WM

SEGMENTS = ("mutate_segment", "eval_segment", "select_segment")


def thresholds(cell: H.Cell) -> np.ndarray:
    """(C, N_METRICS) float32: the mix's constraints dealt round-robin
    over the chunk's runs, in the configuration's metric order (magnitude
    metrics as upper bounds, absent ones +inf; boolean ones as the level
    1 where required, else -inf)."""
    order = cell.config["circuit"]["metrics"]
    rows = []
    for c in cell.traffic["constraints"]:
        rows.append([float(c[m]) if m in c and not isinstance(c[m], bool)
                     else (1.0 if c.get(m) is True else
                           (-np.inf if m in ("acc0", "gauss") else np.inf))
                     for m in order])
    rows = np.array(rows, np.float32)
    return rows[np.arange(cell.traffic["runs"]) % len(rows)]


def _state_rows(state, idx) -> dict:
    pick = lambda t: t[idx].cpu().numpy()
    return {"key": pick(state.key).astype(np.uint32),
            "nodes": pick(state.parent.nodes).astype(np.int64),
            "outs": pick(state.parent.outs).astype(np.int64),
            "metrics": pick(state.parent_metrics).astype(np.float64),
            "power": pick(state.parent_power).astype(np.float64),
            "fit": pick(state.parent_fit).astype(np.float64),
            "best_fit": pick(state.best_fit).astype(np.float64)}


def run(cell: H.Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", control: bool = False):
    from repro_torch.core import evolve as E
    from repro_torch.core import golden as G
    from repro_torch.core import simulate as S
    from repro_torch.core.genome import CGPSpec, Genome
    from repro_torch.kernels import ops

    dev = torch.device(device)
    t, p = cell.traffic, cell.params
    problem = C.Problem(cell.config, dev)
    gold_n, gold_o = problem.golden_genome()
    spec = CGPSpec(problem.n_i, problem.n_o, problem.n_n)
    ecfg = E.EvolveConfig(generations=t["generations"], lam=t["lam"],
                          mutation_rate=t["mutation_rate"],
                          gauss_sigma=problem.sigma)
    gold = Genome(torch.tensor(gold_n, dtype=torch.int32, device=dev),
                  torch.tensor(gold_o, dtype=torch.int32, device=dev))
    planes = torch.tensor(S.input_planes_np(spec.n_i), device=dev)
    gvals = torch.tensor(G.golden_values(problem.width, "mul"), device=dev)
    thr_np = thresholds(cell)
    thr = torch.tensor(thr_np, device=dev)
    runs = t["runs"]

    def chunk(i):
        keys = torch.tensor(seeds.words(seed, "keys", i, (runs, 2)),
                            dtype=torch.int64, device=dev)
        return E.init_state_batched(spec, ecfg, gold, thr, planes, gvals,
                                    keys)

    step = E.make_batched_generation_step(spec, ecfg)
    state, n_chunk, gen_in_chunk = chunk(0), 0, 0
    for _ in range(t["warmup_generations"]):
        state = step(state, thr, planes, gvals)
        gen_in_chunk += 1
    setup_end = H.set_up_done(dev)

    def advance(state, n_chunk, gen_in_chunk):
        if gen_in_chunk == t["generations"]:
            state, n_chunk, gen_in_chunk = chunk(n_chunk + 1), n_chunk + 1, 0
        return state, step(state, thr, planes, gvals), n_chunk, \
            gen_in_chunk + 1

    trace, metrics, gens = None, {}, 0
    if not traced:
        win = H.Window(seconds)
        while win.more():
            prev, state, n_chunk, gen_in_chunk = advance(state, n_chunk,
                                                         gen_in_chunk)
            gens += 1
        H.sync(dev)
        elapsed = win.close()
        metrics["runs_per_s"] = runs * gens / t["generations"] / elapsed
    else:
        trace, prev, state, gens = _traced(cell, advance, state, dev, E, ops,
                                           n_chunk, gen_in_chunk)
    peak = H.peak(dev)

    idx = np.sort(seeds.rng(seed, "check").choice(
        runs, size=min(p["check_runs"], runs), replace=False))
    pre, post = _state_rows(prev, idx), _state_rows(state, idx)
    del prev, state, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    per_run = J.judge(problem, pre, post, thr_np[idx].astype(np.float64),
                      t["lam"], t["mutation_rate"])
    checks = [H.Check(k, float(per_run[k].max()), p["limits"][k])
              for k in p["limits"]]
    failed = int(sum((per_run[k] > p["limits"][k]) for k in p["limits"])
                 .astype(bool).sum())
    out = H.Outcome(attempted=runs * gens, failed=failed, metrics=metrics,
                    checks=checks, device=seeds.device_info(dev, peak),
                    trace=trace)
    if control:
        low = J.judge(problem, pre, J.control(problem, pre, thr_np[idx].astype(
            np.float64), t["lam"], t["mutation_rate"]),
            thr_np[idx].astype(np.float64), t["lam"], t["mutation_rate"])
        out.control = {k: float(v.max()) for k, v in low.items()}
    return out, setup_end


def _traced(cell, advance, state, dev, E, ops, n_chunk, gen_in_chunk):
    """The profiled window, then the synchronised spans: (Trace, the state
    before the last generation, the state after, generations run)."""
    from bench.trace import from_profiler, profiler
    n = cell.traffic["trace_generations"]
    launches = []

    def keep(fn):
        def inner(genomes, *a, **k):
            launches.append((genomes.nodes, genomes.outs))
            return fn(genomes, *a, **k)
        return inner

    wraps = {(E, s): H.labelled(s) for s in SEGMENTS}
    wraps[(ops, "cgp_eval_batched")] = keep
    with H.Patched(wraps), profiler(dev) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            prev, state, n_chunk, gen_in_chunk = advance(state, n_chunk,
                                                         gen_in_chunk)
        H.sync(dev)
        window_s = time.perf_counter() - t0
    trace = from_profiler(prof, window_s)
    pr = C.Problem(cell.config, "cpu")
    W = (1 << pr.n_i) // 32
    trace.calls["cgp_sim"] = [
        WM.bound_ms(int(WM.active_counts(nd.cpu().numpy(), ou.cpu().numpy(),
                                         pr.n_i, pr.one_input.numpy()).sum()),
                    nd.shape[0], pr.n_i, pr.n_n, pr.n_o, W)
        for nd, ou in launches]

    spans = {s: [] for s in SEGMENTS}

    def timed(name):
        def wrap(fn):
            def inner(*a, **k):
                H.sync(dev)
                t1 = time.perf_counter()
                r = fn(*a, **k)
                H.sync(dev)
                spans[name].append((time.perf_counter() - t1) * 1e3)
                return r
            return inner
        return wrap

    with H.Patched({(E, s): timed(s) for s in SEGMENTS}):
        for _ in range(n):
            prev, state, n_chunk, gen_in_chunk = advance(state, n_chunk,
                                                         gen_in_chunk)
    trace.spans = spans
    trace.info["generations"] = n
    return trace, prev, state, 2 * n
