"""Result shards of the port against the JAX package's (schema v3).

The port's ``grid_fingerprint`` / ``schema_fingerprint`` give the JAX
package's hex digests; a width-3 multiplier sweep streamed by each package
(mae and wce constraints, 2 seeds, ``history="summary"``, chunks of 2)
writes shard sets that either package's ``SweepResultReader`` opens, with
identical manifests, integer columns equal and float columns within rtol
1e-6 (power and MRE are float32 sums taken in another order).
"""
import json
import os

import numpy as np
import pytest
import torch

from repro.core.evolve import EvolveConfig as JEvolveConfig
from repro.core.fitness import ConstraintSpec as JConstraint
from repro.core.results import SweepResultReader as JReader
from repro.core.results import schema_fingerprint as j_schema_fingerprint
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.sweep import SweepConfig as JSweepConfig
from repro.core.sweep import grid_fingerprint as j_grid_fingerprint
from repro.core.sweep import run_sweep_batched as j_run_sweep_batched
from repro.core.sweep import sweep_grid as j_sweep_grid
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.results import (HISTORY_FIELDS, MANIFEST,
                                      SUMMARY_FIELDS, SweepResultReader,
                                      SweepResultWriter, schema_fingerprint)
from repro_torch.core.search import SearchConfig
from repro_torch.core.sweep import (SweepConfig, grid_fingerprint,
                                    run_sweep_batched, sweep_grid)
from repro_torch.launch import evolve as t_evolve

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RTOL = 1e-6
CONSTRAINTS = [dict(mae=1.0), dict(wce=5.0)]
SEEDS = (0, 1)
WIDTH, NODES, GENS, LAM = 3, 60, 60, 4


def _configs(gens=GENS):
    return (JSearchConfig(width=WIDTH, kind="mul", n_n=NODES,
                          evolve=JEvolveConfig(generations=gens, lam=LAM)),
            SearchConfig(width=WIDTH, kind="mul", n_n=NODES,
                         evolve=EvolveConfig(generations=gens, lam=LAM)))


def _assert_columns_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=RTOL, err_msg=key)
        else:
            assert np.array_equal(x, y), key


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    """(jax results dir, port results dir) of the same summary-mode grid."""
    jcfg, tcfg = _configs()
    jdir = str(tmp_path_factory.mktemp("jax-shards"))
    tdir = str(tmp_path_factory.mktemp("port-shards"))
    j_run_sweep_batched(jcfg, [JConstraint(**c) for c in CONSTRAINTS], SEEDS,
                        JSweepConfig(chunk_size=2, keep_history="summary",
                                     results_dir=jdir))
    res = run_sweep_batched(tcfg, [ConstraintSpec(**c) for c in CONSTRAINTS],
                            SEEDS, SweepConfig(chunk_size=2,
                                               keep_history="summary",
                                               results_dir=tdir),
                            device="cpu")
    assert res.hist_fit is None and res.completed == 4
    return jdir, tdir


@pytest.mark.parametrize("mode", ["full", "summary", "none"])
@pytest.mark.parametrize("cons", [
    [dict(mae=1.0), dict(wce=5.0)],
    [dict(er=40.0, acc0=True), dict(gauss=True, gauss_sigma=2.5),
     dict(mre=10.0, avg=3.0)]])
def test_grid_fingerprint_matches_jax(mode, cons):
    jcfg, tcfg = _configs()
    want = j_grid_fingerprint(
        jcfg, j_sweep_grid([JConstraint(**c) for c in cons], (0, 3)), mode)
    got = grid_fingerprint(
        tcfg, sweep_grid([ConstraintSpec(**c) for c in cons], (0, 3)), mode)
    assert got == want


@pytest.mark.parametrize("mode", ["full", "summary", "none"])
def test_schema_fingerprint_matches_jax(mode):
    dims = {"gens": 60, "n_metrics": 7, "n_n": 400, "n_o": 16}
    assert schema_fingerprint(mode, dims) == j_schema_fingerprint(mode, dims)


def test_manifests_are_identical(shard_dirs):
    jdir, tdir = shard_dirs
    manifests = []
    for d in shard_dirs:
        with open(os.path.join(d, MANIFEST)) as f:
            manifests.append(json.load(f))
    assert manifests[0] == manifests[1]
    assert manifests[1]["problem"] == {"width": WIDTH, "kind": "mul",
                                       "n_n": NODES}
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))


def test_jax_reader_opens_port_shards(shard_dirs):
    jdir, tdir = shard_dirs
    want, got = JReader(jdir), JReader(tdir)
    assert got.fingerprint == want.fingerprint and got.completed == 4
    _assert_columns_equal(got.summary(), want.summary())
    n = 0
    for (rows_g, hist_g), (rows_w, hist_w) in zip(got.iter_history(),
                                                  want.iter_history()):
        assert np.array_equal(rows_g, rows_w)
        _assert_columns_equal(hist_g, hist_w)
        n += 1
    assert n == 2
    for a, b in zip(got.records(), want.records()):
        assert (a.constraint, a.seed, a.certified) == (b.constraint, b.seed,
                                                      b.certified)
        assert np.array_equal(a.genome_nodes, b.genome_nodes)


def test_port_reader_opens_jax_shards(shard_dirs):
    jdir, _ = shard_dirs
    got, want = SweepResultReader(jdir), JReader(jdir)
    assert got.spans() == want.spans() and got.completed == want.completed
    assert got.keep_history == "summary" and got.problem == want.problem
    for key, col in want.summary().items():
        assert np.array_equal(got.summary([k for k in SUMMARY_FIELDS
                                           if k != "grid_rows"])[key], col)
    assert np.array_equal(got.done_mask(), want.done_mask())
    for (rows_g, hist_g), (rows_w, hist_w) in zip(got.iter_history(),
                                                  want.iter_history()):
        assert np.array_equal(rows_g, rows_w)
        for k in HISTORY_FIELDS:
            assert np.array_equal(hist_g[k], hist_w[k])
    for a, b in zip(got.records(), want.records()):
        assert (a.constraint, a.seed, a.feasible, a.power_rel) == (
            b.constraint, b.seed, b.feasible, b.power_rel)
        assert np.array_equal(a.metrics, b.metrics)


def test_writing_into_another_grids_directory_raises(shard_dirs, tmp_path):
    _, tcfg = _configs(gens=GENS + 1)
    with pytest.raises(ValueError, match="different sweep"):
        run_sweep_batched(tcfg, [ConstraintSpec(mae=1.0)], (0,),
                          SweepConfig(chunk_size=2,
                                      results_dir=shard_dirs[1]),
                          device="cpu")


def test_history_none_shards_and_full_in_ram(tmp_path):
    _, tcfg = _configs(gens=10)
    cons = [ConstraintSpec(**c) for c in CONSTRAINTS]
    none_dir, full_dir = str(tmp_path / "none"), str(tmp_path / "full")
    run_sweep_batched(tcfg, cons, SEEDS, SweepConfig(
        chunk_size=3, keep_history="none", results_dir=none_dir),
        device="cpu")
    full = run_sweep_batched(tcfg, cons, SEEDS, SweepConfig(
        chunk_size=3, keep_history="full", results_dir=full_dir),
        device="cpu")
    reader = SweepResultReader(none_dir)
    with pytest.raises(ValueError, match="no per-generation histories"):
        next(reader.iter_history())
    assert reader.spans() == [(0, 3), (3, 4)]
    summary = reader.summary(["metrics", "parent_nodes"])
    assert np.array_equal(summary["metrics"], full.metrics)
    hist = np.zeros_like(full.hist_fit)
    for rows, h in SweepResultReader(full_dir).iter_history():
        hist[rows] = h["hist_fit"]
    assert np.array_equal(hist, full.hist_fit)
    with pytest.raises(ValueError, match="not summary fields"):
        reader.summary(["hist_fit"])


def test_writer_checks_rows(tmp_path):
    w = SweepResultWriter(str(tmp_path), grid_fingerprint="f" * 64,
                          grid_meta=[{"constraint": "mae<=1%", "seed": 0,
                                      "gauss_sigma": 256.0}],
                          n_runs=1, gens=2, n_n=5, n_o=2,
                          keep_history="none", chunk_size=1,
                          chunk_spans=[(0, 1)])
    rows = {k: np.zeros((1,) + tuple(w._dims[d] if isinstance(d, str) else d
                                     for d in shape), dtype)
            for k, (shape, dtype) in SUMMARY_FIELDS.items()}
    with pytest.raises(ValueError, match="shard fields"):
        w.write_chunk((0, 1), {**rows, "hist_fit": np.zeros((1, 2))})
    with pytest.raises(ValueError, match="shape"):
        w.write_chunk((0, 1), {**rows, "metrics": np.zeros((1, 6))})
    w.write_chunk((0, 1), rows)
    assert w.spans() == [(0, 1)]
    assert JReader(str(tmp_path)).completed == 1
    with pytest.raises(ValueError, match="keep_history"):
        SweepResultWriter(str(tmp_path / "x"), grid_fingerprint="f",
                          grid_meta=[], n_runs=0, gens=0, n_n=1, n_o=1,
                          keep_history="bogus", chunk_size=1, chunk_spans=[])


def test_cli_streams_shards(tmp_path, capsys):
    d = str(tmp_path / "cli")
    t_evolve.main(["--width", "2", "--kind", "mul", "--nodes", "30",
                   "--constraint", "mae=5", "--generations", "10",
                   "--seeds", "2", "--results-dir", d, "--history",
                   "summary", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[evolve] 1 result shards (2/2 runs, history mode 'summary')" in out
    assert JReader(d).completed == 2
