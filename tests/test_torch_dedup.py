"""Phenotype dedup of the port against the JAX package, on the CPU.

Three layers, as in the reference's ``test_dedup.py``:

  1. the canonical form and digests: byte-equal to ``repro.core.genome``'s
     on seeded random populations at widths 2-4 (with near-copies of the
     golden circuit, so duplicates occur) and on mutants of the golden
     400-node 8×8 multiplier; invariant under exactly the changes that
     keep the active subgraph;
  2. ``PhenotypeLRU``: its bound, eviction order and counters;
  3. the sweep: dedup on equals dedup off within the port (records,
     arrays, histories, shard bytes), and equals the JAX package's dedup
     sweep (genomes, integer metrics and ``dedup_stats`` exact; power and
     MRE, float32 sums taken in another order, within rtol 1e-6), also
     under sampled evaluation with the exact tier.  A run that splits from
     the reference's is replayed to its split, which must be a selection
     between powers within a few float32 ulp (and then the counters of the
     runs after it are not compared).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.core import genome as j_genome
from repro.core.evolve import EvolveConfig as JEvolveConfig
from repro.core.fitness import ConstraintSpec as JConstraint
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.sweep import SweepConfig as JSweepConfig
from repro.core.sweep import run_sweep_batched as j_run_sweep_batched
from repro_torch.core import gates, golden
from repro_torch.core import sweep as sweep_mod
from repro_torch.core.evalcache import CacheStats, PhenotypeLRU
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.genome import (PHENOTYPE_DIGEST_SIZE, CGPSpec, Genome,
                                     active_mask_np,
                                     canonicalize_phenotypes_np,
                                     phenotype_digest, phenotype_digests)
from repro_torch.core.search import SearchConfig
from repro_torch.core.sweep import SweepConfig, run_sweep_batched
from test_torch_evolve import _assert_last_bit_tie, _first_split

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RTOL = 1e-6
# the metrics that are exact across packages (MRE is a float32 sum)
EXACT_METRICS = [0, 1, 2, 4, 5, 6]
AND, OR, INV = 2, 3, 1          # INV is a one-input gate
CONSTRAINTS = [dict(mae=0.5), dict(er=50.0)]
SEEDS = (0, 1)
N_RUNS = len(CONSTRAINTS) * len(SEEDS)
GRIDS = {  # name: (width, kind, n_n, generations, lam)
    "add2": (2, "add", 40, 40, 4),
    "mul3": (3, "mul", 60, 60, 4),
}


# ---------------------------------------------------------------------------
# 1. the canonical form and digests
# ---------------------------------------------------------------------------

def _population(rng, spec: CGPSpec, R: int, parent=None, rate=0.01):
    """R legal genomes: uniform random ones, and (with ``parent``) half of
    them the parent with each gene redrawn at ``rate``, so phenotypes
    repeat."""
    hi = spec.n_i + np.arange(spec.n_n)
    nodes = np.stack([rng.integers(0, hi, (R, spec.n_n)),
                      rng.integers(0, hi, (R, spec.n_n)),
                      rng.integers(0, spec.n_funcs, (R, spec.n_n))],
                     axis=-1).astype(np.int32)
    outs = rng.integers(0, spec.n_wires, (R, spec.n_o)).astype(np.int32)
    if parent is not None:
        near = np.arange(R) % 2 == 0
        keep = rng.random((R, spec.n_n, 3)) >= rate
        nodes[near] = np.where(keep[near], parent[0], nodes[near])
        outs[near] = parent[1]
    return nodes, outs


def _cases():
    rng = np.random.default_rng(20)
    for width in (2, 3, 4):
        for kind in ("mul", "add"):
            build = (golden.array_multiplier if kind == "mul"
                     else golden.ripple_carry_adder)
            # 16 spare nodes past the circuit: inactive genes to mutate
            gold, spec = build(width, build(width)[1].n_n + 16)
            parent = (gold.nodes.numpy(), gold.outs.numpy())
            yield (f"w{width}-{kind}", spec) + _population(rng, spec, 64,
                                                           parent)
    gold, spec = golden.array_multiplier(8, 400)
    parent = (gold.nodes.numpy(), gold.outs.numpy())
    nodes, outs = _population(rng, spec, 32, parent, rate=0.001)
    nodes[0], outs[0] = parent            # the golden circuit itself
    yield ("w8-golden-400", spec, nodes, outs)


CASES = list(_cases())


def _j_spec(spec: CGPSpec):
    return j_genome.CGPSpec(n_i=spec.n_i, n_o=spec.n_o, n_n=spec.n_n)


@pytest.mark.parametrize("name,spec,nodes,outs", CASES,
                         ids=[c[0] for c in CASES])
def test_canonical_form_and_digests_match_reference(name, spec, nodes, outs):
    js = _j_spec(spec)
    got = canonicalize_phenotypes_np(nodes, outs, spec)
    want = j_genome.canonicalize_phenotypes_np(nodes, outs, js)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert np.array_equal(active_mask_np(nodes, outs, spec),
                          j_genome.active_mask_np(nodes, outs, js))
    digests = phenotype_digests(nodes, outs, spec)
    assert digests == j_genome.phenotype_digests(nodes, outs, js)
    assert all(len(d) == PHENOTYPE_DIGEST_SIZE for d in digests)
    # the population repeats phenotypes (the golden's near-copies)
    assert len(set(digests)) < len(digests)
    # one genome at a time, from tensors
    for r in (0, 1, len(nodes) - 1):
        g = Genome(torch.as_tensor(nodes[r]), torch.as_tensor(outs[r]))
        assert phenotype_digest(g, spec) == digests[r]


SPEC = CGPSpec(n_i=2, n_o=1, n_n=4)


def _genome(nodes, outs, spec=SPEC) -> Genome:
    full = np.zeros((spec.n_n, 3), np.int32)
    full[:len(nodes)] = np.asarray(nodes, np.int32)
    return Genome(torch.as_tensor(full),
                  torch.as_tensor(np.asarray(outs, np.int32)))


BASE = ([[0, 1, AND]], [SPEC.n_i + 0])
# (same phenotype as BASE?, nodes, outs)
DIGEST_CASES = {
    "inactive-mutation": (True, [[0, 1, AND], [0, 0, OR],
                                 [1, SPEC.n_i + 0, OR]], [SPEC.n_i + 0]),
    "position-shift": (True, [[1, 0, OR], [0, 0, INV], [0, 1, AND]],
                       [SPEC.n_i + 2]),
    "function-change": (False, [[0, 1, OR]], [SPEC.n_i + 0]),
    "commutative-swap-not-folded": (False, [[1, 0, AND]], [SPEC.n_i + 0]),
    "fanin-change": (False, [[0, 0, AND]], [SPEC.n_i + 0]),
    "output-rewired": (False, [[0, 1, AND]], [0]),
}


@pytest.mark.parametrize("case", sorted(DIGEST_CASES))
def test_digest_follows_the_active_subgraph(case):
    same, nodes, outs = DIGEST_CASES[case]
    base = phenotype_digest(_genome(*BASE), SPEC)
    assert base == phenotype_digest(_genome(*BASE), SPEC)
    assert (phenotype_digest(_genome(nodes, outs), SPEC) == base) == same


def test_unary_second_fanin_ignored():
    assert gates.ONE_INPUT[INV] == 1
    a = _genome([[0, 0, INV]], [SPEC.n_i + 0])
    b = _genome([[0, 1, INV]], [SPEC.n_i + 0])
    assert phenotype_digest(a, SPEC) == phenotype_digest(b, SPEC)
    mask = active_mask_np(a.nodes.numpy()[None], a.outs.numpy()[None],
                          SPEC)[0]
    assert mask.tolist() == [True, False, True, False, False, False]


# ---------------------------------------------------------------------------
# 2. the LRU
# ---------------------------------------------------------------------------

def test_lru_bound_and_eviction_order():
    lru = PhenotypeLRU(max_entries=2)
    lru.put("a", 1)
    lru.put("b", 2)
    assert lru.get("a") == 1      # refresh "a": "b" is now least recent
    lru.put("c", 3)
    assert len(lru) == 2
    assert "b" not in lru and lru.get("b") is None
    assert lru.get("a") == 1 and lru.get("c") == 3
    assert lru.stats.evictions == 1 and lru.stats.inserts == 3
    lru.clear()
    assert len(lru) == 0


@pytest.mark.parametrize("max_entries", [0, -1])
def test_lru_refuses_a_bound_below_one(max_entries):
    with pytest.raises(ValueError, match="max_entries"):
        PhenotypeLRU(max_entries=max_entries)


def test_lru_counters_and_hit_rate():
    st = CacheStats(candidates=10, evaluated=3)
    assert st.hit_rate == pytest.approx(0.7)
    assert CacheStats().hit_rate == 0.0
    d = st.as_dict()
    assert d["candidates"] == 10 and d["hit_rate"] == pytest.approx(0.7)
    assert list(d) == ["candidates", "evaluated", "lru_hits", "dup_hits",
                       "inserts", "overwrites", "evictions", "hit_rate"]


def test_lru_overwrite_not_counted_as_insert():
    lru = PhenotypeLRU(max_entries=2)
    lru.put("a", 1)
    lru.put("a", 2)          # an overwrite, not an insert
    lru.put("b", 3)
    lru.put("c", 4)          # evicts "a"
    st = lru.stats
    assert (st.inserts, st.overwrites, st.evictions) == (3, 1, 1)
    assert st.inserts == len(lru) + st.evictions
    assert lru.get("c") == 4 and lru.get("a") is None


# ---------------------------------------------------------------------------
# 3. the sweep: dedup on == dedup off == the JAX package's dedup sweep
# ---------------------------------------------------------------------------

def _cfgs(grid, evolve_kw=None):
    """(the port's SearchConfig, the JAX package's) of ``grid``."""
    width, kind, n_n, gens, lam = GRIDS[grid]
    kw = dict(generations=gens, lam=lam, **(evolve_kw or {}))
    return (SearchConfig(width=width, kind=kind, n_n=n_n,
                         evolve=EvolveConfig(**kw)),
            JSearchConfig(width=width, kind=kind, n_n=n_n,
                          evolve=JEvolveConfig(**kw)))


def _port(grid, dedup, results_dir=None, evolve_kw=None, **sweep_kw):
    return run_sweep_batched(
        _cfgs(grid, evolve_kw)[0], [ConstraintSpec(**c) for c in CONSTRAINTS],
        SEEDS, SweepConfig(chunk_size=N_RUNS, dedup=dedup,
                           results_dir=results_dir, **sweep_kw),
        device="cpu")


def _jax(grid, dedup, results_dir=None, evolve_kw=None):
    return j_run_sweep_batched(
        _cfgs(grid, evolve_kw)[1], [JConstraint(**c) for c in CONSTRAINTS],
        SEEDS, JSweepConfig(chunk_size=N_RUNS, dedup=dedup,
                            results_dir=results_dir))


def _splits(grid, got, want, evolve_kw=None) -> dict:
    """Runs of the port's sweep ``got`` that split from the reference's
    ``want``, by the generation of the split, each proven a last-bit power
    tie (power and MRE are float32 sums taken in another order)."""
    tcfg, jcfg = _cfgs(grid, evolve_kw)
    split = {}
    for i, (tr, jr) in enumerate(zip(got.records, want.records)):
        assert (tr.constraint, tr.seed) == (jr.constraint, jr.seed)
        gen = _first_split(want.hist_fit, got.hist_fit, i)
        # a neutral step to an offspring of the parent's power but other
        # metrics splits the metrics' history before the fitness history
        moved = np.flatnonzero((got.hist_metrics[i] != want.hist_metrics[i])
                               [:, EXACT_METRICS].any(axis=1))
        if moved.size and (gen is None or moved[0] < gen):
            gen = int(moved[0])
        if gen is None and np.array_equal(tr.genome_nodes, jr.genome_nodes):
            continue
        assert gen is not None, f"run {i}: genomes split, histories not"
        _assert_last_bit_tie(jcfg, tcfg,
                             JConstraint(**CONSTRAINTS[i // len(SEEDS)]),
                             jr.seed, gen)
        split[i] = gen
    # a split must stay the rare exception it is argued to be
    assert len(split) <= 1, split
    return split


def _shard_bytes(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith((".npz", ".json"))}


@pytest.fixture(scope="module", params=sorted(GRIDS))
def runs(request, tmp_path_factory):
    """(grid, port off, port on, JAX on, their result directories)."""
    grid = request.param
    dirs = {k: str(tmp_path_factory.mktemp(f"{grid}-{k}"))
            for k in ("off", "on", "jax")}
    copies = dict.fromkeys(sweep_mod.DEDUP_COPIES, 0)
    sweep_mod.DEDUP_COPIES.update(copies)
    on = _port(grid, True, dirs["on"])
    copies = dict(sweep_mod.DEDUP_COPIES)
    return dict(grid=grid, off=_port(grid, False, dirs["off"]), on=on,
                jax=_jax(grid, True, dirs["jax"]), dirs=dirs, copies=copies)


ARRAYS = ("thresholds", "metrics", "power_rel", "feasible", "best_fit",
          "hist_power_rel", "hist_fit", "hist_metrics", "done_mask",
          "certified_mask", "metrics_stderr")


def test_dedup_on_equals_off(runs):
    off, on = runs["off"], runs["on"]
    assert on.completed == off.completed == N_RUNS
    for ra, rb in zip(off.records, on.records):
        assert (ra.constraint, ra.seed, ra.power_rel, ra.feasible) == \
            (rb.constraint, rb.seed, rb.power_rel, rb.feasible)
        assert np.array_equal(ra.genome_nodes, rb.genome_nodes)
        assert np.array_equal(ra.genome_outs, rb.genome_outs)
        assert np.array_equal(ra.metrics, rb.metrics)
    for field in ARRAYS:
        assert np.array_equal(getattr(off, field), getattr(on, field)), field
    assert _shard_bytes(runs["dirs"]["off"]) == _shard_bytes(
        runs["dirs"]["on"])
    assert off.dedup_stats is None


def _assert_close_to_reference(got, want, split, dirs=None):
    """The port's result ``got`` against the reference's ``want``: runs
    that did not split equal in genomes and integer columns, float columns
    within rtol; with ``dirs`` (port, reference) the same for the shards,
    and the manifests byte-equal."""
    same = np.ones(got.n_runs, bool)
    same[list(split)] = False
    for field in ARRAYS:
        a = getattr(got, field)[same]
        b = np.asarray(getattr(want, field))[same]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=field)
        else:
            assert np.array_equal(a, b), field
    for i in np.flatnonzero(same):
        ra, rb = got.records[i], want.records[i]
        assert np.array_equal(ra.genome_nodes, rb.genome_nodes)
        assert np.array_equal(ra.genome_outs, rb.genome_outs)
        assert (ra.feasible, ra.certified) == (rb.feasible, rb.certified)
    if dirs is None:
        return
    a, b = (_shard_bytes(d) for d in dirs)
    assert a.keys() == b.keys()
    assert a["manifest.json"] == b["manifest.json"]
    for name in a:
        if not name.endswith(".npz"):
            continue
        with np.load(os.path.join(dirs[0], name)) as za, \
                np.load(os.path.join(dirs[1], name)) as zb:
            assert za.files == zb.files
            rows = np.isin(za["grid_rows"], np.flatnonzero(same))
            for k in za.files:
                if za[k].dtype.kind == "f":
                    np.testing.assert_allclose(za[k][rows], zb[k][rows],
                                               rtol=RTOL)
                else:
                    assert np.array_equal(za[k][rows], zb[k][rows]), (name, k)


def test_dedup_equals_the_reference(runs):
    on, ref = runs["on"], runs["jax"]
    split = _splits(runs["grid"], on, ref)
    if not split:      # a split run draws other offspring from its split on
        assert on.dedup_stats == ref.dedup_stats
    _assert_close_to_reference(on, ref, split,
                               (runs["dirs"]["on"], runs["dirs"]["jax"]))


def test_dedup_counters(runs):
    st = runs["on"].dedup_stats
    _, _, _, gens, lam = GRIDS[runs["grid"]]
    assert st["candidates"] == N_RUNS * lam * gens
    assert st["evaluated"] + st["lru_hits"] + st["dup_hits"] \
        == st["candidates"]
    assert 0.2 < st["hit_rate"] < 1.0
    assert st["inserts"] == st["evaluated"] and st["evictions"] == 0
    # one copy of the genes out and one of the gathered results in a
    # generation; the miss rows' two copies only where a generation missed
    copies = runs["copies"]
    assert copies["genomes_to_host"] == copies["gathered_to_card"] == gens
    assert copies["miss_rows_to_card"] == copies["miss_results_to_host"]
    assert 0 < copies["miss_rows_to_card"] <= gens


def test_a_small_cache_evicts_and_keeps_the_runs():
    full = _port("add2", True)
    small = _port("add2", True, dedup_cache_size=2)
    st = small.dedup_stats
    assert st["evictions"] > 0 and st["inserts"] == 2 + st["evictions"]
    assert st["evaluated"] > full.dedup_stats["evaluated"]
    for field in ARRAYS:
        assert np.array_equal(getattr(full, field), getattr(small, field))


SAMPLED = dict(eval_mode="sampled", sample_size=64, certify=True,
               certify_budget=1)


def test_dedup_under_sampled_evaluation_and_certification(tmp_path):
    dirs = {k: str(tmp_path / k) for k in ("off", "on", "jax")}
    off = _port("mul3", False, dirs["off"], SAMPLED)
    on = _port("mul3", True, dirs["on"], SAMPLED)
    ref = _jax("mul3", True, dirs["jax"], SAMPLED)
    assert on.certify_stats == off.certify_stats
    assert on.certify_stats["escalated"] > 0
    for field in ARRAYS:
        assert np.array_equal(getattr(off, field), getattr(on, field)), field
    assert _shard_bytes(dirs["off"]) == _shard_bytes(dirs["on"])
    split = _splits("mul3", on, ref, SAMPLED)
    if not split:
        assert on.dedup_stats == ref.dedup_stats
        assert on.certify_stats == ref.certify_stats
    _assert_close_to_reference(on, ref, split, (dirs["on"], dirs["jax"]))


def test_dedup_knob_inherits_the_evolve_config():
    cfg = SearchConfig(width=2, kind="add", n_n=40,
                       evolve=EvolveConfig(generations=2, lam=4, dedup=True))
    con = [ConstraintSpec(mae=0.5)]
    res = run_sweep_batched(cfg, con, (0,), SweepConfig(chunk_size=1),
                            device="cpu")
    assert res.dedup_stats is not None      # SweepConfig.dedup=None defers
    # an explicit False overrides it: the dedup / model_axis refusal is not
    # met, so the error is the missing mesh's
    with pytest.raises(ValueError, match="mesh"):
        run_sweep_batched(cfg, con, (0,), SweepConfig(
            chunk_size=1, dedup=False, model_axis="model"), device="cpu")


def test_dedup_refuses_model_axis_before_the_mesh_check():
    cfg = SearchConfig(width=2, kind="add", n_n=40,
                       evolve=EvolveConfig(generations=2, lam=4))
    with pytest.raises(ValueError, match="dedup is incompatible"):
        run_sweep_batched(cfg, [ConstraintSpec(mae=0.5)], (0,), SweepConfig(
            chunk_size=1, dedup=True, model_axis="model"), device="cpu")


@pytest.mark.parametrize("size", [0, -3])
def test_dedup_cache_size_validated(size):
    with pytest.raises(ValueError, match="dedup_cache_size"):
        SweepConfig(dedup_cache_size=size)
    with pytest.raises(ValueError):
        JSweepConfig(dedup_cache_size=size)
