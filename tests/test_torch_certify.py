"""The exact certification tier: the port on the CPU against the JAX
package.

``certified_metrics`` must equal the reference's bit for bit, in both of
its regimes (the whole cube in one dispatch, and the chunked pass that a
small ``dispatch_rows`` forces), for multipliers and adders: the integer
partials are exact in any order, and the MRE sums are numpy's float64 sums
in the reference's order.  The policy helpers are pure functions and must
agree on every input.  A certified sweep escalates the same rows, to the
same metrics, as the reference's; power_rel is a float32 sum taken in
another order (rtol 1e-6), and stderr rtol 1e-5 (``test_torch_sampling``).

The heavy legs (width-8 oracles, a width-12 escalation through 16 slices of
the 2^24-row cube) carry the ``certify`` marker, as their counterparts in
``tests/test_certify.py`` do.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import certify as j_certify
from repro.core import golden as JG
from repro.core import metrics as j_metrics
from repro.core import simulate as j_simulate
from repro.core.evolve import EvolveConfig as JEvolveConfig
from repro.core.fitness import ConstraintSpec as JConstraint
from repro.core.genome import Genome as JGenome
from repro.core.mutate import mutate_population as j_mutate_population
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.sweep import SweepConfig as JSweepConfig
from repro.core.sweep import run_sweep_batched as j_run_sweep_batched
from repro_torch.core import certify
from repro_torch.core import golden as G
from repro_torch.core import metrics as M
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.search import SearchConfig
from repro_torch.core.sweep import SweepConfig, run_sweep_batched

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RTOL = 1e-6
STDERR_RTOL = 1e-5
EXACT_METRICS = [M.MAE, M.WCE, M.ER, M.AVG, M.ACC0, M.GAUSS]


def _mutants(width, kind, n_n, count, rate=0.05, seed=0):
    """(reference spec, port spec, nodes, outs): mutated copies of the
    reference's golden netlist (small, nonzero errors), as
    ``tests/test_certify.py`` draws them."""
    jbuild = JG.array_multiplier if kind == "mul" else JG.ripple_carry_adder
    build = G.array_multiplier if kind == "mul" else G.ripple_carry_adder
    gold, jspec = jbuild(width, n_n=n_n)
    _, spec = build(width, n_n=n_n)
    assert (spec.n_i, spec.n_o, spec.n_n) == (jspec.n_i, jspec.n_o,
                                              jspec.n_n)
    pop = j_mutate_population(jax.random.PRNGKey(seed), gold, jspec, count,
                              rate)
    return jspec, spec, np.asarray(pop.nodes), np.asarray(pop.outs)


# ---------------------------------------------------------------------------
# certified_metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sigma", [256.0, 3.7])
@pytest.mark.parametrize("regime", ["whole", "chunked"])
@pytest.mark.parametrize("width,kind,n_n", [
    (3, "mul", 64), (4, "mul", 80), (5, "mul", 120), (3, "add", 30),
    (4, "add", 40), (5, "add", 60)])
def test_certified_metrics_match_reference(width, kind, n_n, regime, sigma):
    jspec, spec, nodes, outs = _mutants(width, kind, n_n, 4, seed=width)
    n = 1 << spec.n_i
    rows = certify.DISPATCH_ROWS if regime == "whole" else min(128, n // 2)
    got = certify.certified_metrics_batched(nodes, outs, spec, kind, width,
                                            sigma, dispatch_rows=rows,
                                            device="cpu")
    assert got.dtype == np.float32 and got.shape == (4, M.N_METRICS)
    for i in range(len(nodes)):
        want = j_certify.certified_metrics(nodes[i], outs[i], jspec, kind,
                                           width, sigma, dispatch_rows=rows)
        assert np.array_equal(got[i], want), (i, got[i], want)
        one = certify.certified_metrics(nodes[i], outs[i], spec, kind, width,
                                        sigma, dispatch_rows=rows,
                                        device="cpu")
        assert np.array_equal(one, want)


def test_certified_metrics_equal_the_exhaustive_oracle():
    """Both regimes against the reference's numpy oracle over the whole
    cube (its independent simulation, finalized by ``metrics_np``):
    integer metrics exact, MRE within rtol 1e-6 in the chunked regime."""
    jspec, spec, nodes, outs = _mutants(5, "mul", 120, 3, seed=9)
    n = 1 << spec.n_i
    for i in range(len(nodes)):
        cvals = j_simulate.simulate_values_np(
            JGenome(nodes[i], outs[i]), jspec)[:n]
        oracle = j_metrics.metrics_np(JG.golden_values(5, "mul")[:n], cvals,
                                      spec.n_o, 256.0)
        whole = certify.certified_metrics(nodes[i], outs[i], spec, "mul", 5,
                                          256.0, device="cpu")
        assert np.array_equal(whole, oracle)
        chunked = certify.certified_metrics(nodes[i], outs[i], spec, "mul",
                                            5, 256.0, dispatch_rows=128,
                                            device="cpu")
        assert np.array_equal(chunked[EXACT_METRICS], oracle[EXACT_METRICS])
        np.testing.assert_allclose(chunked[M.MRE], oracle[M.MRE], rtol=RTOL)


def test_certified_metrics_take_tensors_on_their_device():
    _, spec, nodes, outs = _mutants(4, "mul", 80, 2)
    want = certify.certified_metrics_batched(nodes, outs, spec, "mul", 4,
                                             256.0, device="cpu")
    got = certify.certified_metrics_batched(torch.tensor(nodes),
                                            torch.tensor(outs), spec, "mul",
                                            4, 256.0)
    assert np.array_equal(got, want)


def test_certified_metrics_default_to_the_card(monkeypatch):
    _, spec, nodes, outs = _mutants(3, "mul", 64, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        certify.certified_metrics(nodes[0], outs[0], spec, "mul", 3, 256.0)


@pytest.mark.parametrize("n_i,start,n_rows", [(6, 0, 64), (8, 96, 64),
                                              (10, 512, 256), (24, 1 << 20,
                                                               1024)])
def test_cube_slice_planes_match_reference(n_i, start, n_rows):
    got = certify.cube_slice_planes(n_i, start, n_rows)
    want = j_certify.cube_slice_planes(n_i, start, n_rows)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("n_i,start,n_rows", [(4, 0, 32), (6, 0, 64),
                                              (8, 96, 64), (10, 512, 256),
                                              (24, 15 << 20, 4096)])
def test_device_slice_planes_equal_the_packed_ones(n_i, start, n_rows):
    got = certify._slice_planes(n_i, start, n_rows, torch.device("cpu"))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          j_certify.cube_slice_planes(n_i, start, n_rows))
    with pytest.raises(ValueError):
        certify._slice_planes(n_i, start + 16, n_rows, torch.device("cpu"))


def test_cube_slice_planes_refuse_partial_words():
    for mod in (certify, j_certify):
        for rows in (0, 16, 48):
            with pytest.raises(ValueError):
                mod.cube_slice_planes(6, 0, rows)


@pytest.mark.parametrize("width,kind,start,n_rows", [
    (3, "mul", 0, 64), (4, "add", 32, 96), (12, "mul", 1 << 20, 4096)])
def test_golden_slice_matches_reference(width, kind, start, n_rows):
    got = certify._golden_slice(width, kind, start, n_rows)
    want = j_certify._golden_slice(width, kind, start, n_rows)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError):
        certify._golden_slice(width, "div", start, n_rows)
    _, spec, nodes, outs = _mutants(3, "mul", 64, 1)
    for rows in (certify.DISPATCH_ROWS, 32):
        with pytest.raises(ValueError):
            certify.certified_metrics(nodes[0], outs[0], spec, "div", 3,
                                      256.0, dispatch_rows=rows,
                                      device="cpu")


# ---------------------------------------------------------------------------
# the policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget,ramp", [(1, 1.0), (4, 1.0), (8, 1.0),
                                         (8, 0.0), (3, 0.5), (5, 2.5)])
def test_certify_policy_budgets_match_reference(budget, ramp):
    ours = certify.CertifyPolicy(budget=budget, ramp=ramp)
    ref = j_certify.CertifyPolicy(budget=budget, ramp=ramp)
    for n in (1, 2, 3, 10, 33):
        caps = [ours.chunk_budget(i, n) for i in range(n)]
        assert caps == [ref.chunk_budget(i, n) for i in range(n)]
        assert caps[0] == budget
        assert all(a <= b for a, b in zip(caps, caps[1:]))
    assert ours.dispatch_rows == ref.dispatch_rows == certify.DISPATCH_ROWS


@pytest.mark.parametrize("kw", [dict(budget=0), dict(ramp=-0.1),
                                dict(dispatch_rows=33),
                                dict(dispatch_rows=16)])
def test_certify_policy_refuses_as_reference(kw):
    for cls in (certify.CertifyPolicy, j_certify.CertifyPolicy):
        with pytest.raises(ValueError):
            cls(**kw)


@pytest.mark.parametrize("seed", range(6))
def test_select_escalations_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40))
    feas = rng.random(n) < 0.6
    power = rng.choice([0.25, 0.5, 0.75, 1.0], n).astype(np.float32)
    done = rng.random(n) < 0.2
    for budget in (0, 1, 3, n, n + 5):
        got = certify.select_escalations(feas, power, done, budget)
        want = j_certify.select_escalations(feas, power, done, budget)
        assert np.array_equal(got, want)
        assert not done[got].any() and feas[got].all()


def test_feasible_np_and_requires_certification_match_reference():
    rng = np.random.default_rng(1)
    specs = [ConstraintSpec(mae=1.0, wce=1.5), ConstraintSpec(wce=0.5,
                                                              acc0=True),
             ConstraintSpec(er=50.0, gauss=True, gauss_sigma=3.7),
             ConstraintSpec(mae=0.2), ConstraintSpec(mre=3.0, avg=1.0),
             ConstraintSpec(acc0=True), ConstraintSpec()]
    for con in specs:
        t = con.thresholds()
        assert certify.requires_certification(t) == \
            j_certify.requires_certification(t)
        for _ in range(16):
            m = rng.uniform(0, 2, M.N_METRICS).astype(np.float32)
            m[M.ACC0] = float(rng.integers(0, 2))
            m[M.GAUSS] = float(rng.integers(0, 2))
            assert certify.feasible_np(m, t) == j_certify.feasible_np(m, t)
    assert certify.UNCERTIFIABLE == j_certify.UNCERTIFIABLE
    assert certify.requires_certification(ConstraintSpec(wce=1).thresholds())
    assert not certify.requires_certification(
        ConstraintSpec(mae=1, er=5).thresholds())


# ---------------------------------------------------------------------------
# the escalation driver
# ---------------------------------------------------------------------------

def _sweep(budget, certify_on=True):
    cons = [dict(wce=25.0, acc0=True), dict(mae=8.0), dict(wce=10.0)]
    kw = dict(generations=40, lam=3, eval_mode="sampled", sample_size=128,
              certify=certify_on, certify_budget=budget)
    jres = j_run_sweep_batched(
        JSearchConfig(width=4, kind="mul", n_n=80,
                      evolve=JEvolveConfig(**kw)),
        [JConstraint(**c) for c in cons], (0, 1),
        JSweepConfig(chunk_size=2, keep_history="none"))
    tres = run_sweep_batched(
        SearchConfig(width=4, kind="mul", n_n=80, evolve=EvolveConfig(**kw)),
        [ConstraintSpec(**c) for c in cons], (0, 1),
        SweepConfig(chunk_size=2, keep_history="none"), device="cpu")
    return jres, tres


@pytest.mark.parametrize("budget,dispatch_rows", [(8, certify.DISPATCH_ROWS),
                                                  (1, certify.DISPATCH_ROWS),
                                                  (1, 64)])
def test_certified_sweep_matches_reference(budget, dispatch_rows,
                                          monkeypatch):
    """Three chunks of 2 runs; budget 1 ramps the caps 1, 2, 2, so the
    selection by power matters; 64-row slices (the port's only) take the
    chunked pass against the reference's whole-cube dispatch."""
    monkeypatch.setattr(certify, "DISPATCH_ROWS", dispatch_rows)
    jres, tres = _sweep(budget)
    assert tres.certify_stats == jres.certify_stats
    assert tres.certify_stats["escalated"] == tres.certified_mask.sum() > 0
    assert np.array_equal(tres.certified_mask, jres.certified_mask)
    assert np.array_equal(tres.feasible, jres.feasible)
    for i, (tr, jr) in enumerate(zip(tres.records, jres.records)):
        assert np.array_equal(tr.genome_nodes, jr.genome_nodes), i
        assert np.array_equal(tr.genome_outs, jr.genome_outs), i
        assert tr.certified == jr.certified
        np.testing.assert_allclose(tr.power_rel, jr.power_rel, rtol=RTOL)
        if tr.certified:
            # the exact tier's vector: bit for bit, no sampling error
            assert np.array_equal(tr.metrics, jr.metrics), i
            assert not tr.metrics_stderr.any()
            assert tr.feasible == certify.feasible_np(tr.metrics,
                                                      tres.thresholds[i])
        else:
            assert np.array_equal(tr.metrics[EXACT_METRICS],
                                  jr.metrics[EXACT_METRICS]), i
            np.testing.assert_allclose(tr.metrics[M.MRE], jr.metrics[M.MRE],
                                       rtol=RTOL)
            np.testing.assert_allclose(tr.metrics_stderr, jr.metrics_stderr,
                                       rtol=STDERR_RTOL, atol=0)


def test_certified_rows_dominate_the_sample():
    """A certified WCE bounds the sampled one from above, and every row the
    driver certified was feasible on the sample."""
    _, tres = _sweep(8)
    _, plain = _sweep(8, certify_on=False)
    cert = tres.certified_mask
    assert cert.any()
    assert (tres.metrics[cert, M.WCE] >= plain.metrics[cert, M.WCE]).all()
    assert plain.feasible[cert].all()
    assert np.array_equal(tres.metrics[~cert], plain.metrics[~cert])
    assert not plain.certified_mask.any() and plain.certify_stats is None


def test_exhaustive_rows_are_certified_by_the_census():
    cfg = SearchConfig(width=3, kind="mul", n_n=64, evolve=EvolveConfig(
        generations=15, lam=3, certify=True))
    res = run_sweep_batched(cfg, [ConstraintSpec(mae=8.0)], (0, 1),
                            SweepConfig(chunk_size=2, keep_history="none"),
                            device="cpu")
    assert res.certified_mask.all() and all(r.certified for r in res.records)
    assert res.certify_stats is None and not res.metrics_stderr.any()


# ---------------------------------------------------------------------------
# heavy legs (``certify`` marker)
# ---------------------------------------------------------------------------

@pytest.mark.certify
def test_width8_certified_metrics_match_reference():
    jspec, spec, nodes, outs = _mutants(8, "mul", None, 4, rate=0.02)
    got = certify.certified_metrics_batched(nodes, outs, spec, "mul", 8,
                                            256.0, device="cpu")
    chunked = certify.certified_metrics_batched(nodes, outs, spec, "mul", 8,
                                                256.0, dispatch_rows=8192,
                                                device="cpu")
    for i in range(len(nodes)):
        assert np.array_equal(got[i], j_certify.certified_metrics(
            nodes[i], outs[i], jspec, "mul", 8, 256.0))
        assert np.array_equal(chunked[i], j_certify.certified_metrics(
            nodes[i], outs[i], jspec, "mul", 8, 256.0, dispatch_rows=8192))


@pytest.mark.certify
def test_width12_sampled_certified_sweep_matches_reference():
    """The reference's acceptance scenario: a width-12 sampled sweep under
    certification escalates its elite through 16 slices of the 2^24-row
    cube."""
    _, spec = G.array_multiplier(12)
    kw = dict(generations=3, lam=2, eval_mode="sampled", sample_size=2048,
              certify=True, certify_budget=1)
    jres = j_run_sweep_batched(
        JSearchConfig(width=12, kind="mul", n_n=spec.n_n,
                      evolve=JEvolveConfig(**kw)), [JConstraint(wce=25.0)],
        (0,), JSweepConfig(chunk_size=1, keep_history="none"))
    tres = run_sweep_batched(
        SearchConfig(width=12, kind="mul", n_n=spec.n_n,
                     evolve=EvolveConfig(**kw)), [ConstraintSpec(wce=25.0)],
        (0,), SweepConfig(chunk_size=1, keep_history="none"), device="cpu")
    assert tres.certify_stats == jres.certify_stats
    assert tres.certify_stats["escalated"] == 1
    tr, jr = tres.records[0], jres.records[0]
    assert tr.certified and not tr.metrics_stderr.any()
    assert np.array_equal(tr.genome_nodes, jr.genome_nodes)
    assert np.array_equal(tr.metrics, jr.metrics)
