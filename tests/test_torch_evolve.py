"""Evolution and sweep: the port on the CPU against the JAX package.

(a) Teacher-forced: both packages start from the same JAX ``EvolveState``
    (carried across by ``repro_torch.convert``) and run one batched
    generation: identical offspring, selections, keys and genomes.
(b) Free-running: the port's ``run_sweep_batched`` on the CPU against JAX
    ``run_sweep_batched(backend="jnp")`` at widths 3-4, mul and add, under
    mae / er / wce / acc0 / mre constraints, ~100 generations.

Genomes, keys and the MAE/WCE/ER/AVG/ACC0/GAUSS values must be identical.
Power and MRE are float32 sums taken in another order (rtol 1e-6), so a
run may split where the (1+λ) '≤' selection compares two powers within a
few ulp; where a run splits, the test replays it to the first differing
generation and asserts that the split is such a last-bit tie.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.evolve import EvolveConfig as JEvolveConfig
from repro.core.evolve import eval_segment, mutate_segment
from repro.core.evolve import init_state_batched as j_init_state_batched
from repro.core.evolve import make_batched_generation_step as j_make_step
from repro.core.fitness import ConstraintSpec as JConstraint
from repro.core.fitness import fitness as j_fitness
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.search import problem_arrays as j_problem_arrays
from repro.core.sweep import SweepConfig as JSweepConfig
from repro.core.sweep import evolve_chunk as j_evolve_chunk
from repro.core.sweep import run_sweep_batched as j_run_sweep_batched
from repro_torch import convert
from repro_torch import random as R
from repro_torch.core import metrics as M
from repro_torch.core.evolve import (EvolveConfig, eval_population, evolve,
                                     init_state, init_state_batched,
                                     make_batched_generation_step,
                                     make_generation_step)
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.fitness import fitness as t_fitness
from repro_torch.core.genome import Genome
from repro_torch.core.mutate import mutate_population
from repro_torch.core.search import (SearchConfig, problem_arrays,
                                     run_sweep, run_sweep_serial)
from repro_torch.core.sweep import (SweepConfig, plan_chunks,
                                    run_sweep_batched)

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RTOL = 1e-6
EXACT_METRICS = [M.MAE, M.WCE, M.ER, M.AVG, M.ACC0, M.GAUSS]
CONSTRAINTS = [dict(mae=1.0), dict(er=40.0), dict(wce=5.0),
               dict(acc0=True, mae=2.0), dict(mre=5.0)]
SEEDS = (0, 1)
GENS = 100
CHUNK = 4


def _configs(width, kind, n_n, gens=GENS, lam=4):
    return (JSearchConfig(width=width, kind=kind, n_n=n_n,
                          evolve=JEvolveConfig(generations=gens, lam=lam)),
            SearchConfig(width=width, kind=kind, n_n=n_n,
                         evolve=EvolveConfig(generations=gens, lam=lam)))


def _assert_close_fit(a, b, what):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert np.array_equal(np.isinf(a), np.isinf(b)), what
    f = np.isfinite(a)
    np.testing.assert_allclose(a[f], b[f], rtol=RTOL, err_msg=what)


def _assert_metrics(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert np.array_equal(a[..., EXACT_METRICS], b[..., EXACT_METRICS]), what
    np.testing.assert_allclose(a[..., M.MRE], b[..., M.MRE], rtol=RTOL,
                               err_msg=what)


def _jax_state(jcfg, thr, seeds, gens):
    """The JAX batched state after ``gens`` generations from the golden."""
    gold, spec, planes, gvals, gpower = j_problem_arrays(jcfg)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    state, *_ = j_evolve_chunk(
        spec, dataclasses.replace(jcfg.evolve, generations=gens), gold,
        jnp.asarray(thr), planes, gvals, gpower, keys)
    return state, (gold, spec, planes, gvals, gpower)


def _port_problem(tcfg):
    return problem_arrays(tcfg, "cpu")


# ---------------------------------------------------------------------------
# (a) teacher-forced generation step
# ---------------------------------------------------------------------------

def _refresh_fitness(state, spec, tthr, planes, gvals, sigma):
    """The state with its parent and best fitness re-derived by the port.

    Each package compares powers it computed itself; the reference's
    float32 sums carried across would make every neutral offspring (same
    phenotype as the parent, hence the same power) a last-bit tie."""
    def fit(g):
        res = eval_population(g, spec, planes, gvals, sigma)
        return res.cost.power, t_fitness(res.cost.power, res.metric_vec, tthr)

    power, parent_fit = fit(state.parent)
    _, best_fit = fit(state.best)
    return state._replace(parent_fit=parent_fit, parent_power=power,
                          best_fit=best_fit)


def test_teacher_forced_generation():
    # the same problem, chunk shape and budget as the (4, add) sweep below,
    # so the reference's compiled chunk program is shared
    jcfg, tcfg = _configs(4, "add", 40)
    cons = [JConstraint(**c) for c in CONSTRAINTS[:CHUNK]]
    thr = np.stack([c.thresholds() for c in cons])
    jstate, (_, jspec, jplanes, jgvals, _) = _jax_state(jcfg, thr,
                                                        range(CHUNK), GENS)
    _, spec, tplanes, tgvals, _ = _port_problem(tcfg)
    tthr = convert.thresholds(thr)
    tstate = convert.evolve_state(jstate)
    tstate = _refresh_fitness(tstate, spec, tthr, tplanes, tgvals, 256.0)
    for name in ("parent_fit", "parent_power", "best_fit"):
        _assert_close_fit(getattr(tstate, name).numpy(),
                          getattr(jstate, name), name)

    # same offspring from the same keys
    jkeys, joff = mutate_segment(jspec, jcfg.evolve, jstate)
    keys = R.split(tstate.key)
    toff = mutate_population(keys[:, 1], tstate.parent, spec,
                             tcfg.evolve.lam, tcfg.evolve.mutation_rate)
    assert np.array_equal(keys[:, 0].numpy(), np.asarray(jkeys, np.int64))
    assert np.array_equal(toff.nodes.numpy(), np.asarray(joff.nodes))
    assert np.array_equal(toff.outs.numpy(), np.asarray(joff.outs))

    # one generation in each package: identical selections
    jnext = jax.jit(lambda s: j_make_step(jspec, jcfg.evolve)(
        s, jnp.asarray(thr), jplanes, jgvals, 0))(jstate)
    tnext = make_batched_generation_step(spec, tcfg.evolve)(
        tstate, tthr, tplanes, tgvals)
    for name in ("parent", "best"):
        jg, tg = getattr(jnext, name), getattr(tnext, name)
        assert np.array_equal(tg.nodes.numpy(), np.asarray(jg.nodes)), name
        assert np.array_equal(tg.outs.numpy(), np.asarray(jg.outs)), name
    assert np.array_equal(tnext.key.numpy(), np.asarray(jnext.key, np.int64))
    _assert_metrics(tnext.parent_metrics.numpy(), jnext.parent_metrics,
                    "parent_metrics")
    for name in ("parent_fit", "parent_power", "best_fit"):
        _assert_close_fit(getattr(tnext, name).numpy(),
                          getattr(jnext, name), name)


def test_init_state_matches():
    jcfg, tcfg = _configs(4, "mul", 80)
    cons = [JConstraint(**c) for c in CONSTRAINTS]
    thr = np.stack([c.thresholds() for c in cons])
    jgold, jspec, jplanes, jgvals, jgpower = j_problem_arrays(jcfg)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in range(len(cons))])
    js = jax.jit(lambda t, k: j_init_state_batched(
        jspec, jcfg.evolve, jgold, t, jplanes, jgvals, k))(jnp.asarray(thr),
                                                           keys)
    tgold, spec, tplanes, tgvals, tgpower = _port_problem(tcfg)
    np.testing.assert_allclose(float(tgpower), float(jgpower), rtol=RTOL)
    ts = init_state_batched(spec, tcfg.evolve, tgold, convert.thresholds(thr),
                            tplanes, tgvals, convert.keys(keys))
    assert np.array_equal(ts.parent.nodes.numpy(), np.asarray(js.parent.nodes))
    _assert_metrics(ts.parent_metrics.numpy(), js.parent_metrics, "init")
    _assert_close_fit(ts.parent_fit.numpy(), js.parent_fit, "init fit")


# ---------------------------------------------------------------------------
# (b) free-running sweeps
# ---------------------------------------------------------------------------

def _first_split(j_hist_fit, t_hist_fit, i):
    a, b = np.asarray(j_hist_fit[i]), np.asarray(t_hist_fit[i])
    close = np.isclose(a, b, rtol=RTOL) | (np.isinf(a) & np.isinf(b))
    return int(np.flatnonzero(~close)[0]) if not close.all() else None


def _assert_last_bit_tie(jcfg, tcfg, con, seed, gen):
    """Replay run (con, seed) in both packages to just before history entry
    ``gen`` and show that the selection there is decided by fitnesses
    within a few float32 ulp of each other."""
    thr = con.thresholds()[None]
    ecfg = dataclasses.replace(jcfg.evolve, gauss_sigma=con.gauss_sigma)
    jstate, (_, jspec, jplanes, jgvals, _) = _jax_state(
        dataclasses.replace(jcfg, evolve=ecfg), thr, [seed], gen)
    _, joff = mutate_segment(jspec, ecfg, jstate)
    jmet, jpow = eval_segment(jspec, ecfg, joff.nodes[0], joff.outs[0],
                              jplanes, jgvals)
    jfit = np.asarray(jax.vmap(j_fitness, (0, 0, None))(
        jpow, jmet, jnp.asarray(thr[0])))
    tgold, spec, tplanes, tgvals, _ = _port_problem(tcfg)
    tstate = convert.evolve_state(jstate)
    toff = mutate_population(R.split(tstate.key)[:, 1], tstate.parent, spec,
                             tcfg.evolve.lam, tcfg.evolve.mutation_rate)
    res = eval_population(Genome(toff.nodes[0], toff.outs[0]), spec, tplanes,
                          tgvals, con.gauss_sigma)
    tfit = t_fitness(res.cost.power, res.metric_vec,
                     convert.thresholds(thr[0])).numpy()
    assert np.array_equal(np.isinf(jfit), np.isinf(tfit)), "feasibility split"
    pfit = float(np.asarray(jstate.parent_fit)[0])
    vals = np.concatenate([jfit[np.isfinite(jfit)], [pfit]])
    ulp = 4 * np.finfo(np.float32).eps * np.abs(vals[np.isfinite(vals)]).max()
    assert np.abs(jfit - tfit)[np.isfinite(jfit)].max(initial=0) <= ulp
    # the decision itself rests on a tie: the least fitness lies within a
    # few ulp of the parent's or of another offspring's
    fin = np.sort(jfit[np.isfinite(jfit)])
    near_parent = fin.size and abs(fin[0] - pfit) <= ulp
    near_other = fin.size > 1 and fin[1] - fin[0] <= ulp
    assert near_parent or near_other, "split is not a last-bit tie"


@pytest.mark.parametrize("width,kind,n_n", [(3, "mul", 60), (4, "add", 40),
                                            (4, "mul", 80)])
def test_sweep_matches_jax(width, kind, n_n):
    jcfg, tcfg = _configs(width, kind, n_n)
    jres = j_run_sweep_batched(jcfg, [JConstraint(**c) for c in CONSTRAINTS],
                               SEEDS, JSweepConfig(chunk_size=CHUNK))
    tres = run_sweep_batched(tcfg, [ConstraintSpec(**c) for c in CONSTRAINTS],
                             SEEDS, SweepConfig(chunk_size=CHUNK), device="cpu")
    assert tres.completed == jres.completed == len(CONSTRAINTS) * len(SEEDS)
    split = {}
    for i, (jr, tr) in enumerate(zip(jres.records, tres.records)):
        assert (tr.constraint, tr.seed) == (jr.constraint, jr.seed)
        gen = _first_split(jres.hist_fit, tres.hist_fit, i)
        if gen is not None or not np.array_equal(tr.genome_nodes,
                                                 jr.genome_nodes):
            assert gen is not None, f"run {i}: genomes split, histories not"
            _assert_last_bit_tie(jcfg, tcfg,
                                 JConstraint(**CONSTRAINTS[i // len(SEEDS)]),
                                 jr.seed, gen)
            split[i] = gen
            continue
        assert np.array_equal(tr.genome_outs, jr.genome_outs)
        _assert_metrics(tr.metrics, jr.metrics, f"run {i} metrics")
        np.testing.assert_allclose(tr.power_rel, jr.power_rel, rtol=RTOL)
        assert tr.feasible == jr.feasible
        scale = max(abs(jr.error_std), 1.0)
        np.testing.assert_allclose(tr.error_mean, jr.error_mean, rtol=1e-5,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(tr.error_std, jr.error_std, rtol=1e-5)
        _assert_close_fit(tres.hist_fit[i], jres.hist_fit[i], f"hist_fit {i}")
        np.testing.assert_allclose(tres.hist_power_rel[i],
                                   jres.hist_power_rel[i], rtol=RTOL)
        _assert_metrics(tres.hist_metrics[i], jres.hist_metrics[i],
                        f"hist_metrics {i}")
        _assert_close_fit(tres.best_fit[i], jres.best_fit[i], f"best {i}")
    # a split must stay the rare exception it is argued to be
    assert len(split) <= 1, split


def test_serial_matches_batched():
    _, tcfg = _configs(2, "add", 30, gens=40)
    cons = [ConstraintSpec(**c) for c in CONSTRAINTS[:3]]
    serial = run_sweep_serial(tcfg, cons, (0, 3), device="cpu")
    batched = run_sweep_batched(tcfg, cons, (0, 3), SweepConfig(chunk_size=4),
                                device="cpu")
    records = run_sweep(tcfg, cons, (0, 3), device="cpu")
    assert len(serial) == len(batched.records) == len(records) == 6
    for a, b, c in zip(serial, batched.records, records):
        assert np.array_equal(b.genome_nodes, c.genome_nodes)
        assert np.array_equal(a.genome_nodes, b.genome_nodes)
        assert np.array_equal(a.metrics, b.metrics)
        assert a.power_rel == b.power_rel and a.feasible == b.feasible


def test_sigma_groups_and_max_chunks():
    _, tcfg = _configs(2, "mul", 30, gens=10)
    cons = [ConstraintSpec(gauss=True, gauss_sigma=s) for s in (2.0, 1.0)]
    cons.append(ConstraintSpec(gauss=True, gauss_sigma=2.0))
    sigmas = np.array([c.gauss_sigma for c in cons for _ in (0, 1)])
    order = np.argsort(sigmas, kind="stable")
    assert plan_chunks(sigmas[order], 8) == [(0, 2), (2, 6)]
    part = run_sweep_batched(tcfg, cons, (0, 1),
                             SweepConfig(chunk_size=8, keep_history="none",
                                         max_chunks=1), device="cpu")
    assert part.completed == 2 and part.hist_fit is None
    assert part.done_mask.tolist() == [False, False, True, True, False, False]
    full = run_sweep_batched(tcfg, cons, (0, 1), SweepConfig(chunk_size=8),
                             device="cpu")
    assert full.completed == 6
    for r in part.records:
        twin = full.records[[(x.constraint, x.seed) for x in full.records]
                            .index((r.constraint, r.seed))]
        assert np.array_equal(r.genome_nodes, twin.genome_nodes)


def test_zero_generations_keep_the_golden_parent():
    _, tcfg = _configs(2, "add", 20, gens=0)
    res = run_sweep_batched(tcfg, [ConstraintSpec(mae=1.0)], (0,),
                            device="cpu")
    gold, *_ = _port_problem(tcfg)
    assert res.hist_fit.shape == (1, 0)
    assert np.array_equal(res.records[0].genome_nodes, gold.nodes.numpy())
    assert res.records[0].power_rel == 1.0


def test_sweep_config_validates():
    with pytest.raises(ValueError):
        SweepConfig(chunk_size=0)
    with pytest.raises(ValueError):
        SweepConfig(keep_history="bogus")
    assert SweepConfig(keep_history="summary").results_dir is None
    with pytest.raises(ValueError, match="layout"):
        SweepConfig(layout="transposed")
    assert SweepConfig(layout="cube_major").layout == "cube_major"


@pytest.mark.parametrize("where", ["sweep", "evolve"])
@pytest.mark.parametrize("layout", ["cube_major", "genome_major", "auto"])
def test_layout_keeps_records_and_fingerprint(where, layout, tmp_path):
    """The layout is an execution knob (``SweepConfig.layout`` overriding
    ``EvolveConfig.layout``): records, shards and the grid fingerprint are
    those of the default, and the fingerprint the JAX package's with the
    same knob set."""
    import dataclasses
    from repro.core.sweep import grid_fingerprint as j_grid_fingerprint
    from repro.core.sweep import sweep_grid as j_sweep_grid
    from repro_torch.core.results import SweepResultReader
    from repro_torch.core.sweep import grid_fingerprint, sweep_grid
    jcfg, tcfg = _configs(3, "mul", 40, gens=15)
    cons = [ConstraintSpec(**c) for c in CONSTRAINTS]
    base = run_sweep_batched(tcfg, cons, SEEDS, SweepConfig(
        chunk_size=CHUNK, results_dir=str(tmp_path / "base")), device="cpu")
    if where == "evolve":
        tcfg = dataclasses.replace(tcfg, evolve=dataclasses.replace(
            tcfg.evolve, layout=layout))
        sweep = SweepConfig(chunk_size=CHUNK, results_dir=str(tmp_path / "x"))
    else:
        sweep = SweepConfig(chunk_size=CHUNK, results_dir=str(tmp_path / "x"),
                            layout=layout)
    other = run_sweep_batched(tcfg, cons, SEEDS, sweep, device="cpu")
    for a, b in zip(other.records, base.records):
        assert np.array_equal(a.genome_nodes, b.genome_nodes)
        assert np.array_equal(a.metrics, b.metrics)
        assert a.power_rel == b.power_rel and a.feasible == b.feasible
    assert np.array_equal(other.hist_fit, base.hist_fit)
    fps = {SweepResultReader(str(tmp_path / d)).manifest["grid_fingerprint"]
           for d in ("base", "x")}
    jcfg = dataclasses.replace(jcfg, evolve=dataclasses.replace(
        jcfg.evolve, layout=layout))
    want = j_grid_fingerprint(jcfg, j_sweep_grid(
        [JConstraint(**c) for c in CONSTRAINTS], SEEDS), "full")
    assert fps == {grid_fingerprint(tcfg, sweep_grid(cons, SEEDS), "full"),
                   want}


def test_single_run_step_matches_evolve():
    _, tcfg = _configs(3, "mul", 40, gens=5)
    gold, spec, planes, gvals, gpower = _port_problem(tcfg)
    thr = convert.thresholds(ConstraintSpec(er=30.0).thresholds())
    key = R.PRNGKey(4)
    res = evolve(spec, tcfg.evolve, gold, thr, planes, gvals, gpower, key)
    state = init_state(spec, tcfg.evolve, gold, thr, planes, gvals, key)
    step = make_generation_step(spec, tcfg.evolve)
    fits = []
    for _ in range(5):
        state = step(state, thr, planes, gvals)
        fits.append(float(state.parent_fit))
    assert torch.equal(state.parent.nodes, res.parent.nodes)
    assert torch.equal(state.best.outs, res.best.outs)
    assert fits == res.hist_fit.tolist()
    assert res.hist_metrics.shape == (5, M.N_METRICS)
