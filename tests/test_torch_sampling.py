"""Sampled evaluation: the port on the CPU against the JAX package.

The sample streams are numpy in both packages and must agree bit for bit:
operands of every distribution, packed planes, the empirical histogram,
the stream fingerprints and the sampled ``problem_arrays``.  On a sample,
as on the cube, genomes, keys and the MAE/WCE/ER/AVG/ACC0/GAUSS values
must be identical; power and MRE are float32 sums taken in another order
(rtol 1e-6).  ``metric_stderr`` takes float32 arithmetic on ``sq_sum`` and
``rel_sq``, which are such sums too, so stderr agrees to rtol 1e-5.  A run
may split only where the (1+λ) selection compares two powers within a few
ulp; the sweep test replays any split and asserts that it is such a tie.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as j_metrics
from repro.core import sampling as j_sampling
from repro.core.evolve import EvolveConfig as JEvolveConfig
from repro.core.fitness import ConstraintSpec as JConstraint
from repro.core.results import SweepResultReader as JReader
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.search import problem_arrays as j_problem_arrays
from repro.core.search import run_search as j_run_search
from repro.core.sweep import SweepConfig as JSweepConfig
from repro.core.sweep import evolve_chunk as j_evolve_chunk
from repro.core.sweep import grid_fingerprint as j_grid_fingerprint
from repro.core.sweep import run_sweep_batched as j_run_sweep_batched
from repro.core.sweep import sweep_grid as j_sweep_grid
from repro.data import pipeline as j_pipeline
from repro.launch import evolve as j_evolve
from repro_torch import random as R
from repro_torch.core import golden as G
from repro_torch.core import metrics as M
from repro_torch.core import sampling
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.results import SweepResultReader
from repro_torch.core.search import SearchConfig, problem_arrays, run_search
from repro_torch.core.sweep import (SweepConfig, evolve_chunk,
                                    grid_fingerprint, run_sweep_batched,
                                    sweep_grid)
from repro_torch.data import pipeline
from repro_torch.kernels import cgp_sim
from repro_torch.launch import evolve as t_evolve
from test_torch_evolve import _assert_last_bit_tie, _first_split

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RTOL = 1e-6
STDERR_RTOL = 1e-5
EXACT_METRICS = [M.MAE, M.WCE, M.ER, M.AVG, M.ACC0, M.GAUSS]
CONSTRAINTS = [dict(mae=1.0), dict(er=40.0), dict(wce=5.0),
               dict(acc0=True, mae=2.0), dict(mre=5.0)]
SEEDS = (0, 1)
STREAMS = [(3, 64, 0), (4, 100, 7), (6, 2048, 3), (12, 16384, 0),
           (12, 5000, 11)]


def _assert_metrics(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert np.array_equal(a[..., EXACT_METRICS], b[..., EXACT_METRICS]), what
    np.testing.assert_allclose(a[..., M.MRE], b[..., M.MRE], rtol=RTOL,
                               err_msg=what)


def _assert_stderr(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=STDERR_RTOL, atol=0, err_msg=what)


def _configs(width, kind, n_n, gens, lam, **sampled):
    return (JSearchConfig(width=width, kind=kind, n_n=n_n,
                          evolve=JEvolveConfig(generations=gens, lam=lam,
                                               eval_mode="sampled",
                                               **sampled)),
            SearchConfig(width=width, kind=kind, n_n=n_n,
                         evolve=EvolveConfig(generations=gens, lam=lam,
                                             eval_mode="sampled", **sampled)))


# ---------------------------------------------------------------------------
# the streams
# ---------------------------------------------------------------------------

def test_hash_and_token_stream_match_reference():
    x = np.arange(0, 1 << 20, 977, dtype=np.uint64) * np.uint64(0x9E3779B9)
    assert np.array_equal(pipeline._hash_u32(x), j_pipeline._hash_u32(x))
    for cfg in (pipeline.DataConfig(), pipeline.DataConfig(
            vocab=1000, seq_len=64, global_batch=3, seed=5, n_codebooks=4)):
        jcfg = j_pipeline.DataConfig(**dataclasses.asdict(cfg))
        for step in (0, 3):
            got, want = pipeline.synth_batch(cfg, step), \
                j_pipeline.synth_batch(jcfg, step)
            for k in ("tokens", "targets"):
                assert got[k].dtype == want[k].dtype
                assert np.array_equal(got[k], want[k]), (cfg, step, k)


@pytest.mark.parametrize("size", [1, 31, 32, 33, 100, 1 << 14, 5000])
def test_effective_sample_size_matches_reference(size):
    assert sampling.effective_sample_size(size) == \
        j_sampling.effective_sample_size(size)


def test_effective_sample_size_refuses_zero():
    for mod in (sampling, j_sampling):
        with pytest.raises(ValueError):
            mod.effective_sample_size(0)


@pytest.mark.parametrize("dist", sampling.INPUT_DISTS)
@pytest.mark.parametrize("width,size,seed", STREAMS)
def test_operands_and_planes_match_reference(dist, width, size, seed):
    a, b = sampling.sampled_operands(width, size, dist, seed)
    ja, jb = j_sampling.sampled_operands(width, size, dist, seed)
    assert a.dtype == ja.dtype and b.dtype == jb.dtype
    assert np.array_equal(a, ja) and np.array_equal(b, jb)
    assert 0 <= a.min() and a.max() < (1 << width)
    planes = sampling.pack_sample_planes(a, b, width)
    assert planes.dtype == np.int32
    assert np.array_equal(planes, j_sampling.pack_sample_planes(ja, jb, width))
    for kind in ("mul", "add"):
        assert np.array_equal(sampling.sampled_golden_values(a, b, kind),
                              j_sampling.sampled_golden_values(ja, jb, kind))


@pytest.mark.parametrize("width,seed,batches", [(4, 0, 4), (8, 3, 2),
                                                (12, 0, 4)])
def test_empirical_histogram_matches_reference(width, seed, batches):
    got = sampling.empirical_histogram(width, seed, batches)
    want = j_sampling.empirical_histogram(width, seed, batches)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_sampling_refuses_what_the_reference_refuses():
    for mod in (sampling, j_sampling):
        with pytest.raises(ValueError):
            mod.sampled_operands(4, 64, "lognormal")
        with pytest.raises(ValueError):
            mod.pack_sample_planes(np.zeros(33, np.int64),
                                   np.zeros(33, np.int64), 4)
        with pytest.raises(ValueError):
            mod.sampled_golden_values(np.zeros(32), np.zeros(32), "div")


@pytest.mark.parametrize("width,size,dist,seed", [
    (3, 64, "uniform", 0), (4, 100, "gaussian", 7), (8, 16384, "empirical", 1),
    (12, 16384, "uniform", 0), (12, 16000, "uniform", 0)])
def test_stream_fingerprint_matches_reference(width, size, dist, seed):
    assert sampling.stream_fingerprint(width, size, dist, seed) == \
        j_sampling.stream_fingerprint(width, size, dist, seed)


@pytest.mark.parametrize("dist", sampling.INPUT_DISTS)
@pytest.mark.parametrize("width,kind,n_n,size", [(3, "mul", 60, 64),
                                                 (4, "add", 40, 100),
                                                 (8, "mul", 400, 2048)])
def test_sampled_problem_arrays_match_reference(dist, width, kind, n_n, size):
    jcfg, tcfg = _configs(width, kind, n_n, 1, 1, sample_size=size,
                          input_dist=dist, sample_seed=5)
    jgold, jspec, jplanes, jgvals, jgpower = j_problem_arrays(jcfg)
    gold, spec, planes, gvals, gpower = problem_arrays(tcfg, "cpu")
    assert spec.n_n == jspec.n_n
    assert planes.dtype == torch.int32 and gvals.dtype == torch.int32
    assert np.array_equal(planes.numpy(), np.asarray(jplanes))
    assert np.array_equal(gvals.numpy(), np.asarray(jgvals))
    np.testing.assert_allclose(float(gpower), float(jgpower), rtol=RTOL)


def test_evolve_config_validates_as_reference():
    for kw in (dict(eval_mode="census"), dict(input_dist="lognormal"),
               dict(sample_size=0), dict(certify_budget=0)):
        for cls in (EvolveConfig, JEvolveConfig):
            with pytest.raises(ValueError):
                cls(**kw)
    ours, ref = EvolveConfig(), JEvolveConfig()
    for name in ("eval_mode", "sample_size", "input_dist", "sample_seed",
                 "certify", "certify_budget"):
        assert getattr(ours, name) == getattr(ref, name), name


# ---------------------------------------------------------------------------
# metric_stderr
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_o,size,seed", [(6, 64, 0), (8, 4096, 1),
                                           (16, 16384, 2), (24, 16384, 3)])
def test_metric_stderr_matches_reference(n_o, size, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 1 << n_o, size).astype(np.int32)
    cand = np.where(rng.random((5, size)) < 0.3,
                    rng.integers(0, 1 << n_o, (5, size)), g).astype(np.int32)
    cand[0] = g                      # an exact circuit: zero error
    want = np.stack([np.asarray(j_metrics.metric_stderr(
        j_metrics.error_partials(jnp.asarray(g), jnp.asarray(c), 256.0,
                                 n_bits=n_o), n_o)) for c in cand])
    got = M.metric_stderr(M.error_partials(torch.as_tensor(g),
                                           torch.as_tensor(cand), 256.0,
                                           n_bits=n_o), n_o).numpy()
    assert got.dtype == np.float32 and got.shape == (5, M.N_METRICS)
    _assert_stderr(got, want, f"n_o={n_o}")
    assert not got[:, [M.WCE, M.ACC0, M.GAUSS]].any()
    assert not got[0].any()
    oracle = np.stack([j_metrics.metrics_stderr_np(g, c, n_o) for c in cand])
    _assert_stderr(got, oracle, "float64 oracle")


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["none", "summary", "full"])
@pytest.mark.parametrize("evolve", [
    dict(),
    dict(certify=True),
    dict(eval_mode="sampled"),
    dict(eval_mode="sampled", certify=True),
    dict(eval_mode="sampled", certify=True, certify_budget=3),
    dict(eval_mode="sampled", sample_size=100, input_dist="gaussian",
         sample_seed=4),
    dict(eval_mode="sampled", input_dist="empirical", certify=True)])
def test_grid_fingerprint_matches_reference(evolve, mode):
    cons = [dict(mae=1.0), dict(wce=2.0, gauss=True, gauss_sigma=3.7)]
    jcfg = JSearchConfig(width=12, kind="mul", n_n=768,
                         evolve=JEvolveConfig(generations=100, lam=8,
                                              **evolve))
    tcfg = SearchConfig(width=12, kind="mul", n_n=768,
                        evolve=EvolveConfig(generations=100, lam=8, **evolve))
    want = j_grid_fingerprint(
        jcfg, j_sweep_grid([JConstraint(**c) for c in cons], range(16)), mode)
    got = grid_fingerprint(
        tcfg, sweep_grid([ConstraintSpec(**c) for c in cons], range(16)),
        mode)
    assert got == want


def test_exhaustive_fingerprint_ignores_the_sampling_knobs():
    grid = sweep_grid([ConstraintSpec(mae=1.0)], (0,))
    base = grid_fingerprint(SearchConfig(width=3, n_n=60), grid, "none")
    for kw in (dict(certify=True), dict(sample_size=64, input_dist="gaussian",
                                        sample_seed=3, certify_budget=2)):
        cfg = SearchConfig(width=3, n_n=60, evolve=EvolveConfig(**kw))
        assert grid_fingerprint(cfg, grid, "none") == base


# ---------------------------------------------------------------------------
# the kernel's geometry at the sample of width 12
# ---------------------------------------------------------------------------

def test_width12_sample_geometry_fits_or_raises():
    """Width 12, the auto-sized 768-node netlist, W = 512 words (the CLI's
    2^14-row sample): a 101 KB wire plane a warp, 2 warps a genome-major
    block, and cube-major runs that fit beside one plane; a run that does
    not fit raises with the reason."""
    _, spec = G.array_multiplier(12)
    assert (spec.n_i, spec.n_n, spec.n_o) == (24, 768, 24)
    W = sampling.effective_sample_size(1 << 14) // 32
    assert W == 512
    assert 4 * cgp_sim.TILE * (spec.n_i + spec.n_n) == 101376
    assert cgp_sim.block_warps(spec.n_i, spec.n_n, spec.n_o) == 2
    smem = cgp_sim.smem_bytes(spec.n_i, spec.n_n, spec.n_o)
    assert smem <= cgp_sim.MAX_SMEM_BYTES
    assert cgp_sim.blocks_by_smem(smem) == 1
    tiles, r_tile = cgp_sim.cube_defaults(256, W, spec.n_i, spec.n_n,
                                          spec.n_o, sm_count=132)
    assert cgp_sim.block_warps(spec.n_i, spec.n_n, spec.n_o, tiles) >= 1
    assert cgp_sim.smem_bytes(spec.n_i, spec.n_n, spec.n_o, tiles) \
        <= cgp_sim.MAX_SMEM_BYTES
    assert 1 <= r_tile <= 256
    # every candidate of the autotuner fits at this geometry
    for bw in (64, 128, 256, 512):
        t = cgp_sim.run_tiles("cube_major", bw, 256, W, spec.n_i, spec.n_n,
                              spec.n_o, 132)
        assert cgp_sim.smem_bytes(spec.n_i, spec.n_n, spec.n_o, t) \
            <= cgp_sim.MAX_SMEM_BYTES
    # width 13 (n_n auto-sized too) leaves no room for a cube-major run of
    # 17 tiles beside one plane: refused, never run
    _, big = G.array_multiplier(13)
    with pytest.raises(ValueError, match="shared memory"):
        cgp_sim.run_tiles("cube_major", 17 * 32, 256, 1024, big.n_i,
                          big.n_n, big.n_o, 132)
    # and the whole 2^24-row cube of the certification cross-check takes
    # the per-bit magnitude regime, as the sample does
    assert M.exact_sum_per_bit(1 << 24, spec.n_o)
    assert M.exact_sum_per_bit(32 * W, spec.n_o)


@pytest.mark.parametrize("width,kind,what", [(17, "add", "n_i=34"),
                                             (16, "mul", "n_o=32")])
def test_kernel_refuses_widths_it_cannot_run(width, kind, what):
    """A sample reaches widths whose cube never could: the kernel loads at
    most 32 input planes a tile and takes at most 30 outputs, so a wider
    problem is refused before any launch (never run on stale planes), while
    the plain path on the CPU evaluates it."""
    cfg = SearchConfig(width=width, kind=kind, n_n=None,
                       evolve=EvolveConfig(eval_mode="sampled",
                                           sample_size=64))
    gold, spec, planes, gvals, _ = problem_arrays(cfg, "cpu")
    with pytest.raises(ValueError, match=what):
        cgp_sim.cgp_sim_metrics_batched(
            gold.nodes[None], gold.outs[None], planes, gvals, n_i=spec.n_i,
            n_n=spec.n_n, n_o=spec.n_o)
    assert cgp_sim.LAUNCHES == 0
    from repro_torch.kernels import ops
    partials, _ = ops.cgp_eval_batched(
        type(gold)(gold.nodes[None], gold.outs[None]), spec, planes, gvals)
    assert int(partials.err_count[0]) == 0 and int(partials.count[0]) == 64


# ---------------------------------------------------------------------------
# evolution and sweeps on a sample
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dist", ["uniform", "empirical"])
def test_sampled_evolve_chunk_keys_and_genomes(dist):
    """Free-running chunks of 4 runs on a sample, 40 generations: the same
    keys, genomes and integer metrics in both packages."""
    jcfg, tcfg = _configs(4, "mul", 80, 40, 4, sample_size=128,
                          input_dist=dist)
    cons = [JConstraint(**c) for c in CONSTRAINTS[:4]]
    thr = np.stack([c.thresholds() for c in cons])
    jgold, jspec, jplanes, jgvals, jgpower = j_problem_arrays(jcfg)
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in range(4)])
    jstate, _, jhm, jhf = j_evolve_chunk(jspec, jcfg.evolve, jgold,
                                         jnp.asarray(thr), jplanes, jgvals,
                                         jgpower, jkeys)
    gold, spec, planes, gvals, gpower = problem_arrays(tcfg, "cpu")
    keys = torch.stack([R.PRNGKey(s) for s in range(4)])
    state, _, hm, hf = evolve_chunk(spec, tcfg.evolve, gold,
                                    torch.as_tensor(thr), planes, gvals,
                                    gpower, keys)
    assert np.array_equal(state.key.numpy(), np.asarray(jstate.key, np.int64))
    for i in range(4):
        if _first_split(jhf, hf.numpy(), i) is not None:
            continue       # a last-bit tie: test_sampled_sweep replays them
        assert np.array_equal(state.parent.nodes[i].numpy(),
                              np.asarray(jstate.parent.nodes[i])), i
        assert np.array_equal(state.parent.outs[i].numpy(),
                              np.asarray(jstate.parent.outs[i])), i
        _assert_metrics(hm[i].numpy(), np.asarray(jhm[i]), f"history {i}")


@pytest.mark.parametrize("width,kind,n_n,dist", [
    (3, "mul", 60, "uniform"), (4, "add", 40, "gaussian"),
    (4, "mul", 80, "empirical")])
def test_sampled_sweep_matches_jax(width, kind, n_n, dist):
    jcfg, tcfg = _configs(width, kind, n_n, 100, 4, sample_size=128,
                          input_dist=dist, sample_seed=2)
    jres = j_run_sweep_batched(jcfg, [JConstraint(**c) for c in CONSTRAINTS],
                               SEEDS, JSweepConfig(chunk_size=4))
    tres = run_sweep_batched(tcfg, [ConstraintSpec(**c) for c in CONSTRAINTS],
                             SEEDS, SweepConfig(chunk_size=4), device="cpu")
    assert tres.completed == jres.completed == len(CONSTRAINTS) * len(SEEDS)
    assert tres.certify_stats is None and jres.certify_stats is None
    assert not tres.certified_mask.any()
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
        _assert_stderr(tr.metrics_stderr, jr.metrics_stderr, f"run {i}")
        assert tr.metrics_stderr.dtype == np.float32
        np.testing.assert_allclose(tr.power_rel, jr.power_rel, rtol=RTOL)
        assert tr.feasible == jr.feasible
        assert tr.certified is jr.certified is False
        _assert_metrics(tres.hist_metrics[i], jres.hist_metrics[i],
                        f"hist_metrics {i}")
    assert len(split) <= 1, split


def test_width12_sampled_sweep_matches_jax():
    """The reference's tier-1 width-12 scenario: the auto-sized netlist, a
    2048-row sample, 3 generations, λ = 2, chunks of 1."""
    _, spec = G.array_multiplier(12)
    jcfg, tcfg = _configs(12, "mul", spec.n_n, 3, 2, sample_size=2048)
    jres = j_run_sweep_batched(jcfg, [JConstraint(mae=2.0)], (0,),
                               JSweepConfig(chunk_size=1,
                                            keep_history="none"))
    tres = run_sweep_batched(tcfg, [ConstraintSpec(mae=2.0)], (0,),
                             SweepConfig(chunk_size=1, keep_history="none"),
                             device="cpu")
    assert tres.completed == jres.completed == 1
    jr, tr = jres.records[0], tres.records[0]
    assert np.array_equal(tr.genome_nodes, jr.genome_nodes)
    assert np.array_equal(tr.genome_outs, jr.genome_outs)
    _assert_metrics(tr.metrics, jr.metrics, "metrics")
    _assert_stderr(tr.metrics_stderr, jr.metrics_stderr, "stderr")
    np.testing.assert_allclose(tr.power_rel, jr.power_rel, rtol=RTOL)
    assert np.isfinite(tr.metrics).all() and np.isfinite(
        tr.metrics_stderr).all()


def test_sampled_run_search_matches_jax():
    """The serial path: stderr on the sample, and never certified (it has
    no escalation driver)."""
    jcfg, tcfg = _configs(3, "mul", 60, 60, 4, sample_size=64,
                          input_dist="gaussian")
    jrec, _ = j_run_search(jcfg, JConstraint(mae=2.0), seed=3)
    trec, _ = run_search(tcfg, ConstraintSpec(mae=2.0), seed=3, device="cpu")
    assert np.array_equal(trec.genome_nodes, jrec.genome_nodes)
    _assert_metrics(trec.metrics, jrec.metrics, "metrics")
    _assert_stderr(trec.metrics_stderr, jrec.metrics_stderr, "stderr")
    assert trec.certified is jrec.certified is False
    exh, _ = run_search(SearchConfig(width=3, n_n=60, evolve=EvolveConfig(
        generations=5, lam=2)), ConstraintSpec(mae=2.0), device="cpu")
    assert exh.certified and not exh.metrics_stderr.any()


# ---------------------------------------------------------------------------
# resume across the packages, the CLI
# ---------------------------------------------------------------------------

def _shards(d) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        if name.startswith("shard_") and name.endswith(".npz"):
            with np.load(os.path.join(d, name)) as z:
                out.update({(name, k): z[k] for k in z.files})
    return out


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_sampled_results_dir_finished_by_the_other(first, second, tmp_path):
    kw = dict(sample_size=64, input_dist="empirical", certify=True,
              certify_budget=1)
    jcfg, tcfg = _configs(3, "mul", 60, 60, 4, **kw)
    jcons = [JConstraint(mae=1.0), JConstraint(wce=5.0)]
    tcons = [ConstraintSpec(mae=1.0), ConstraintSpec(wce=5.0)]

    def run(which, d, **sweep):
        if which == "jax":
            return j_run_sweep_batched(jcfg, jcons, SEEDS, JSweepConfig(
                chunk_size=2, keep_history="summary", results_dir=d,
                **sweep))
        return run_sweep_batched(tcfg, tcons, SEEDS, SweepConfig(
            chunk_size=2, keep_history="summary", results_dir=d, **sweep),
            device="cpu")

    whole = str(tmp_path / "whole")
    run("jax", whole)
    d = str(tmp_path / "mixed")
    part = run(first, d, max_chunks=1)
    assert part.completed == 2 and part.certify_stats["escalated"] == 1
    done = run(second, d)
    assert done.completed == 4
    # the second call escalated its own chunk only, at the last chunk's
    # budget (the ramp follows the full plan)
    assert done.certify_stats == {"escalated": 2, "certified_rows": 3,
                                  "budget": 1}
    for reader in (SweepResultReader(d), JReader(d)):
        assert reader.completed == 4
        assert reader.manifest["grid_fingerprint"] == \
            JReader(whole).manifest["grid_fingerprint"]
    got, want = _shards(d), _shards(whole)
    assert got.keys() == want.keys()
    for key in want:
        a, b = got[key], want[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if key[1] == "metrics_stderr":
            _assert_stderr(a, b, key)
        elif key[1] in ("metrics", "hist_metrics"):
            _assert_metrics(a, b, key)
        elif a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=str(key))
        else:
            assert np.array_equal(a, b), key


def _rows(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("extra", [
    ["--eval-mode", "sampled", "--sample-size", "64"],
    ["--eval-mode", "sampled", "--sample-size", "100", "--input-dist",
     "gaussian", "--sample-seed", "3", "--certify", "--certify-budget", "2"],
    ["--eval-mode", "exhaustive", "--certify"]])
def test_cli_sampled_rows_match_reference(extra, capsys, monkeypatch):
    args = ["--width", "3", "--kind", "mul", "--nodes", "60", "--constraint",
            "mae=1.0", "--constraint", "wce=5,acc0", "--generations", "60",
            "--lam", "4", "--seeds", "2", "--chunk-size", "2", *extra]
    monkeypatch.setattr(sys, "argv", ["repro.launch.evolve", *args])
    j_evolve.main()
    want = capsys.readouterr().out
    t_evolve.main([*args, "--device", "cpu"])
    got = capsys.readouterr().out
    # the same lines but the rate; stderr rounded to 6 digits may move in
    # its last digit (rtol 1e-5)
    strip = lambda out: [l for l in out.splitlines()
                         if l.startswith("[evolve]") and "runs/s" not in l]
    assert strip(got) == strip(want)
    rows, ref = _rows(got), _rows(want)
    assert len(rows) == len(ref) == 4
    for r, w in zip(rows, ref):
        assert r.keys() == w.keys()
        se, wse = r.pop("metrics_stderr", None), w.pop("metrics_stderr", None)
        assert r == w
        if wse is not None:
            assert se.keys() == wse.keys()
            np.testing.assert_allclose(list(se.values()), list(wse.values()),
                                       rtol=STDERR_RTOL, atol=2e-6)
    sampled = "sampled" in extra
    assert all(("metrics_stderr" in w) == sampled for w in _rows(want))
    assert all(("certified" in w) == (sampled and "--certify" in extra)
               for w in _rows(want))
    if sampled and "--certify" in extra:
        assert "[evolve] certify: " in got


def test_cli_exhaustive_stdout_unchanged(capsys):
    """Without sampling the rows carry exactly the pre-sampling fields and
    no certify line."""
    t_evolve.main(["--width", "2", "--kind", "add", "--nodes", "30",
                   "--constraint", "wce=20", "--generations", "10",
                   "--seeds", "2", "--device", "cpu", "--certify"])
    out = capsys.readouterr().out
    assert "certify" not in out
    for row in _rows(out):
        assert list(row) == ["constraint", "seed", "power_rel", "feasible",
                             "metrics"]


def test_cli_refuses_certify_with_serial(capsys):
    with pytest.raises(SystemExit) as exc:
        t_evolve.main(["--width", "2", "--constraint", "mae=1", "--serial",
                       "--certify", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--certify" in capsys.readouterr().err


def test_cli_help_lists_the_sampling_flags(capsys):
    with pytest.raises(SystemExit):
        t_evolve.main(["--help"])
    out = capsys.readouterr().out
    for flag in ("--eval-mode", "--sample-size", "--sample-seed",
                 "--input-dist", "--certify", "--certify-budget"):
        assert flag in out
