"""The port's circuit model against the JAX package: gates, golden genomes,
golden values, mutation offspring, active masks and critical paths."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gates as jgates
from repro.core import golden as JG
from repro.core.genome import Genome as JGenome
from repro.core.genome import active_mask as j_active_mask
from repro.core.genome import critical_path_ps as j_critical_path
from repro.core.genome import random_genome
from repro.core.mutate import mutate_population as j_mutate_population
from repro_torch import convert
from repro_torch import random as R
from repro_torch.core import gates, golden
from repro_torch.core.genome import (CGPSpec, active_mask, critical_path_ps,
                                     validate_genome)
from repro_torch.core.mutate import mutate_population

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

WIDTHS = range(1, 9)


def _spec(jspec) -> CGPSpec:
    return CGPSpec(n_i=jspec.n_i, n_o=jspec.n_o, n_n=jspec.n_n)


def _random_population(jspec, seed: int, R_: int):
    """R_ stacked JAX random genomes as numpy (nodes, outs)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), R_)
    g = jax.jit(jax.vmap(lambda k: random_genome(k, jspec)))(keys)
    return np.asarray(g.nodes), np.asarray(g.outs)


def test_gate_constants_match():
    for name in ("TRUTH_TABLES", "ONE_INPUT", "SWITCH_ENERGY_FJ",
                 "LEAKAGE_NW", "AREA_UM2", "DELAY_PS"):
        a, b = getattr(jgates, name), getattr(gates, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert gates.TT_PACKED == jgates.TT_PACKED
    assert gates.N_FUNCS == jgates.N_FUNCS


@pytest.mark.parametrize("kind", ["mul", "add"])
@pytest.mark.parametrize("width", WIDTHS)
def test_golden_genome_and_values(width, kind):
    jbuild = JG.array_multiplier if kind == "mul" else JG.ripple_carry_adder
    tbuild = (golden.array_multiplier if kind == "mul"
              else golden.ripple_carry_adder)
    jg, jspec = jbuild(width)
    tg, tspec = tbuild(width)
    assert (tspec.n_i, tspec.n_o, tspec.n_n) == (jspec.n_i, jspec.n_o,
                                                 jspec.n_n)
    assert tg.nodes.dtype == torch.int32 and tg.outs.dtype == torch.int32
    assert np.array_equal(tg.nodes.numpy(), np.asarray(jg.nodes))
    assert np.array_equal(tg.outs.numpy(), np.asarray(jg.outs))
    assert validate_genome(tg, tspec)
    want = JG.golden_values(width, kind)
    got = golden.golden_values(width, kind)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_golden_rejects_small_node_budget():
    with pytest.raises(ValueError):
        golden.array_multiplier(4, n_n=10)


@pytest.mark.parametrize("width,kind,n_n,lam,rate", [
    (3, "mul", 40, 4, 0.05), (4, "add", 60, 8, 0.004),
    (8, "mul", 400, 8, 0.004), (2, "add", 16, 3, 0.3)])
def test_mutate_population_same_offspring(width, kind, n_n, lam, rate):
    jbuild = JG.array_multiplier if kind == "mul" else JG.ripple_carry_adder
    jg, jspec = jbuild(width, n_n=n_n)
    spec = _spec(jspec)
    j_mutate = jax.jit(lambda k: j_mutate_population(k, jg, jspec, lam, rate))
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = j_mutate(key)
        got = mutate_population(convert.keys(key), convert.genome(jg), spec,
                                lam, rate)
        assert got.nodes.dtype == torch.int32
        assert np.array_equal(got.nodes.numpy(), np.asarray(want.nodes))
        assert np.array_equal(got.outs.numpy(), np.asarray(want.outs))
        for i in range(lam):
            assert validate_genome(type(got)(got.nodes[i], got.outs[i]), spec)


def test_mutate_population_batched_over_runs():
    jg, jspec = JG.array_multiplier(3, n_n=40)
    spec = _spec(jspec)
    nodes, outs = _random_population(jspec, 0, 5)
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    want = jax.jit(jax.vmap(lambda k, n, o: j_mutate_population(
        k, JGenome(n, o), jspec, 4, 0.05)))(keys, jnp.asarray(nodes),
                                            jnp.asarray(outs))
    got = mutate_population(convert.keys(keys),
                            convert.genome(JGenome(nodes, outs)), spec, 4,
                            0.05)
    assert np.array_equal(got.nodes.numpy(), np.asarray(want.nodes))
    assert np.array_equal(got.outs.numpy(), np.asarray(want.outs))


@pytest.mark.parametrize("width,kind,n_n", [(2, "mul", 30), (4, "add", 50),
                                            (5, "mul", 120)])
def test_active_mask_and_critical_path(width, kind, n_n):
    jbuild = JG.array_multiplier if kind == "mul" else JG.ripple_carry_adder
    jg, jspec = jbuild(width, n_n=n_n)
    spec = _spec(jspec)
    nodes, outs = _random_population(jspec, width, 6)
    # random genomes and the golden one, which has the longest active paths
    nodes = np.concatenate([nodes, np.asarray(jg.nodes)[None]])
    outs = np.concatenate([outs, np.asarray(jg.outs)[None]])
    want_act, want_cp = jax.jit(jax.vmap(lambda n, o: (
        j_active_mask(JGenome(n, o), jspec),
        j_critical_path(JGenome(n, o), jspec))))(jnp.asarray(nodes),
                                                 jnp.asarray(outs))
    tg = convert.genome(JGenome(nodes, outs))
    assert np.array_equal(active_mask(tg, spec).numpy(), np.asarray(want_act))
    cp = critical_path_ps(tg, spec)
    assert cp.dtype == torch.float32
    assert np.array_equal(cp.numpy(), np.asarray(want_cp))
    # unbatched genomes keep their shape
    one = type(tg)(tg.nodes[-1], tg.outs[-1])
    assert active_mask(one, spec).shape == (spec.n_wires,)
    assert float(critical_path_ps(one, spec)) == float(want_cp[-1])


def test_validate_genome_rejects_illegal():
    tg, spec = golden.array_multiplier(3)
    assert validate_genome(tg, spec)
    bad = tg.nodes.clone()
    bad[0, 0] = spec.n_i  # a node may not read itself
    assert not validate_genome(type(tg)(bad, tg.outs), spec)
    bad_outs = tg.outs.clone()
    bad_outs[0] = spec.n_wires
    assert not validate_genome(type(tg)(tg.nodes, bad_outs), spec)


def test_split_key_device_round_trip():
    key = R.PRNGKey(42)
    assert R.split(key, 3).shape == (3, 2)
    assert convert.keys(jax.random.PRNGKey(42)).tolist() == key.tolist()
