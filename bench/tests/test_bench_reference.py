"""The references against the program at reduced sizes, on the CPU: the
same PRNG stream and offspring, the same golden circuit, metrics, power
and product table, and the LM's projections and loss within float
rounding."""
import json

import numpy as np
import pytest
import torch

from bench.reference import circuit as C
from bench.reference import lm as REF
from conftest import DATA, REPO


def _problem(width=3, nodes=60):
    cfg = json.loads((REPO / "bench" / "configs" / "mul8.json").read_text())
    cfg["circuit"].update(width=width, nodes=nodes)
    return C.Problem(cfg, "cpu")


def _keys(n, seed=0):
    return np.random.default_rng(seed).integers(0, 1 << 32, (n, 2),
                                                dtype=np.uint32)


def test_prng_matches_the_programs_stream():
    from repro_torch import random as R
    k = _keys(5)
    kt = torch.tensor(k.astype(np.int64))
    assert (C.split(k, 3) == R.split(kt, 3).numpy()).all()
    hi = np.array([7, 100, 1 << 20])
    got = C.randint(k[:, None], (3,), hi)
    want = R.randint(kt[:, None], (3,), 0, torch.tensor(hi)).numpy()
    assert (got == want).all()
    assert (C.bernoulli(k, 0.3, (4, 6))
            == R.bernoulli(kt, 0.3, (4, 6)).numpy()).all()


@pytest.mark.parametrize("width,lam", [(3, 4), (4, 8)])
def test_offspring_match_the_programs_mutation(width, lam):
    from repro_torch.core import evolve as E
    from repro_torch.core.genome import CGPSpec, Genome, random_genome
    from repro_torch import random as R
    spec = CGPSpec(2 * width, 2 * width, 60)
    keys = torch.tensor(_keys(6, width).astype(np.int64))
    parents = random_genome(R.split(R.PRNGKey(width), 6), spec)
    cfg = E.EvolveConfig(lam=lam, mutation_rate=0.05)
    state = E.EvolveState(parents, None, None, None, parents, None, keys)
    nk, kids = E.mutate_segment(spec, cfg, state)
    rk, rn, ro = C.offspring(keys.numpy().astype(np.uint32),
                             parents.nodes.numpy().astype(np.int64),
                             parents.outs.numpy().astype(np.int64),
                             spec.n_i, spec.n_funcs, lam, 0.05)
    assert (rk == nk.numpy()).all()
    assert (rn == kids.nodes.numpy()).all() and (ro == kids.outs.numpy()).all()


@pytest.mark.parametrize("width", [2, 3, 5, 8])
def test_golden_circuit_is_the_programs(width):
    from repro_torch.core import golden as G
    n_n = 400 if width == 8 else 120
    gold, _ = G.array_multiplier(width, n_n=n_n)
    p = _problem(width, n_n)
    nodes, outs = p.golden_genome()
    assert (nodes == gold.nodes.numpy()).all()
    assert (outs == gold.outs.numpy()).all()


@pytest.mark.parametrize("width", [3, 4])
def test_metrics_and_power_match_the_programs_evaluation(width):
    from repro_torch.core import evolve as E
    from repro_torch.core import golden as G
    from repro_torch.core import simulate as S
    from repro_torch.core.genome import CGPSpec, Genome, random_genome
    from repro_torch import random as R
    spec = CGPSpec(2 * width, 2 * width, 20 * width)
    gen = random_genome(R.split(R.PRNGKey(3), 24), spec)
    gold, _ = G.array_multiplier(width, n_n=spec.n_n)
    nodes = torch.cat([gold.nodes[None], gen.nodes])
    outs = torch.cat([gold.outs[None], gen.outs])
    res = E.eval_population(
        Genome(nodes, outs), spec,
        torch.tensor(S.input_planes_np(spec.n_i)),
        torch.tensor(G.golden_values(width, "mul")), 256.0)
    p = _problem(width, spec.n_n)
    mets, pows = p.evaluate(nodes.numpy().astype(np.int64),
                            outs.numpy().astype(np.int64))
    np.testing.assert_allclose(res.metric_vec.numpy(), mets, rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(res.cost.power.numpy(), pows, rtol=1e-6)
    assert mets[0, :5].max() == 0 and mets[0, 5:].min() == 1


def test_active_gates_match_the_programs_mask():
    from repro_torch.core.genome import CGPSpec, active_mask, random_genome
    from repro_torch import random as R
    from bench.workmodels import cgp_sim as WM
    spec = CGPSpec(8, 8, 80)
    g = random_genome(R.split(R.PRNGKey(5), 16), spec)
    p = _problem(4, 80)
    nodes, outs = g.nodes.long(), g.outs.long()
    act = C.active_gates(nodes, outs, 8, p.one_input)
    assert (act == active_mask(g, spec)[:, 8:]).all()
    counts = WM.active_counts(nodes.numpy(), outs.numpy(), 8,
                              p.one_input.numpy())
    assert (counts == act.sum(1).numpy()).all()


def test_product_table_is_the_programs():
    from repro_torch.core.genome import CGPSpec, Genome
    from repro_torch.core.library import multiplier_lut
    p = _problem(8, 400)
    nodes, outs = p.golden_genome()
    nodes[150, 2] = p.codes["or"]
    want = multiplier_lut(Genome(torch.tensor(nodes, dtype=torch.int32),
                                 torch.tensor(outs, dtype=torch.int32)),
                          CGPSpec(16, 16, 400))
    got = p.table(nodes, outs)
    assert (got == want).all()
    a = np.arange(256)
    assert (p.table(*p.golden_genome()) == a[:, None] * a[None]).all()


def test_lut_products_are_exact():
    g = torch.Generator().manual_seed(0)
    a = torch.randint(256, (5, 40), generator=g)
    b = torch.randint(256, (40, 12), generator=g)
    t = torch.randint(65536, (256, 256), generator=g)
    want = t[a[:, :, None], b[None]].sum(1)
    assert (REF.lut_products(a, b, t) == want).all()


def test_approx_linear_matches_the_programs_projection():
    from repro_torch.models import quant
    g = torch.Generator().manual_seed(1)
    t = torch.randint(65536, (256, 256), generator=g, dtype=torch.int64)
    x = torch.randn(7, 48, generator=g)
    w = torch.randn(48, 24, generator=g) / 7
    quant.set_multiplier_lut(t.numpy())
    try:
        want = quant.approx_matmul(x, w)
    finally:
        quant.set_multiplier_lut(None)
    got = REF.approx_linear(x, w, t)
    scale = want.abs().max()
    assert float((got - want).abs().max() / scale) < 1e-5


def test_reference_loss_matches_the_programs_lm_loss():
    from bench.drivers import lm as L
    from repro_torch.models import model as M
    from repro_torch.models import quant
    config = json.loads((DATA / "tiny_lm.json").read_text())
    config["program"]["fields"].update(param_dtype="float32",
                                       act_dtype="float32")
    s = L.sizes(config)
    cfg = L.program_config(config)
    w = L.Weights(s, 5, "cpu")
    for k in list(w.views):
        w.views[k] = w.views[k].float()
    w.table = w.table.float()
    params = L.program_model(cfg, w, "cpu")
    for prm in params.parameters():
        prm.data = prm.data.float()
    p = _problem(8, 400)
    nodes, outs = p.golden_genome()
    nodes[200, 2] = p.codes["and"]
    table = p.table(nodes, outs)
    tok = torch.randint(s["vocab_size"], (2, 65),
                        generator=torch.Generator().manual_seed(2))
    quant.set_multiplier_lut(table)
    try:
        with torch.no_grad():
            want = float(M.lm_loss(params, tok[:, :-1], tok[:, 1:], cfg))
    finally:
        quant.set_multiplier_lut(None)
    ref = REF.Model(s, w.weight, lambda: w.table, torch.as_tensor(table))
    got = float(ref.loss(tok[:, :-1], tok[:, 1:]))
    assert abs(got - want) < 1e-4
