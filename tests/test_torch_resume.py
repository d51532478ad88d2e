"""Resumable sweeps of the port against the JAX package.

A width-3 multiplier sweep (mae and wce constraints, 2 seeds, 60 nodes,
λ = 4, chunks of 2: two chunks) interrupted by one package is finished by
the other, through result shards and through checkpoints, and must equal
the uninterrupted run: integer columns exact, float columns within rtol
1e-6 (power and MRE are float32 sums taken in another order).  Also here:
the step checkpoints' on-disk layout and leaf order, quarantine of damaged
shards, schema-v2 and two-pod directories, the Pareto feeds of the reader,
resume under ``model_axis`` on two gloo ranks, and the CLI flags and
examples that drive resume.
"""
import json
import os
import runpy
import shutil
import sys

import numpy as np
import pytest
import torch

from repro.checkpoint import store as j_store
from repro.core.evolve import EvolveConfig as JEvolveConfig
from repro.core.fitness import ConstraintSpec as JConstraint
from repro.core.results import SweepResultReader as JReader
from repro.core.results import SweepResultWriter as JWriter
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.sweep import SweepConfig as JSweepConfig
from repro.core.sweep import run_sweep_batched as j_run_sweep_batched
from repro.launch import evolve as j_evolve
from repro_torch.checkpoint import store
from repro_torch.core import metrics as M
from repro_torch.core import sweep as sweep_mod
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.results import (SUMMARY_FIELDS, SweepResultReader,
                                      SweepResultWriter,
                                      normalize_history_mode, _prefix_spans,
                                      pod_prefix_spans)
from repro_torch.core.search import SearchConfig
from repro_torch.core.sweep import (SweepConfig, _alloc_buffers,
                                    run_sweep_batched)
from repro_torch.launch import evolve as t_evolve

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-6
CONSTRAINTS = [dict(mae=1.0), dict(wce=5.0)]
SEEDS = (0, 1)
WIDTH, NODES, GENS, LAM, CHUNK = 3, 60, 60, 4, 2
N_RUNS = len(CONSTRAINTS) * len(SEEDS)
BUF_KEYS = ("parent_nodes", "parent_outs", "best_nodes", "best_outs",
            "best_fit", "metrics", "metrics_stderr", "power_rel", "feasible",
            "certified_mask", "error_mean", "error_std")
HIST_KEYS = ("hist_power_rel", "hist_fit", "hist_metrics")


def _jax(sweep: dict, seeds=SEEDS):
    cfg = JSearchConfig(width=WIDTH, kind="mul", n_n=NODES,
                        evolve=JEvolveConfig(generations=GENS, lam=LAM))
    return j_run_sweep_batched(cfg, [JConstraint(**c) for c in CONSTRAINTS],
                               seeds, JSweepConfig(chunk_size=CHUNK, **sweep))


def _port(sweep: dict, seeds=SEEDS):
    cfg = SearchConfig(width=WIDTH, kind="mul", n_n=NODES,
                       evolve=EvolveConfig(generations=GENS, lam=LAM))
    return run_sweep_batched(cfg, [ConstraintSpec(**c) for c in CONSTRAINTS],
                             seeds, SweepConfig(chunk_size=CHUNK, **sweep),
                             device="cpu")


RUN = {"jax": _jax, "port": _port}


def _assert_close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=what)
    else:
        assert np.array_equal(got, want), what


def _shard_arrays(d) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        if name.startswith("shard_") and name.endswith(".npz"):
            with np.load(os.path.join(d, name)) as z:
                out.update({(name, k): z[k] for k in z.files})
    return out


def _mtimes(d) -> dict:
    return {n: os.stat(os.path.join(d, n)).st_mtime_ns
            for n in sorted(os.listdir(d))}


@pytest.fixture
def chunk_calls(monkeypatch):
    """Counts the chunks the port's sweep evolves."""
    calls = []
    real = sweep_mod.evolve_chunk

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(sweep_mod, "evolve_chunk", counting)
    return calls


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """An uninterrupted summary-mode shard directory of the JAX package."""
    d = str(tmp_path_factory.mktemp("jax-whole"))
    _jax(dict(keep_history="summary", results_dir=d))
    return d


@pytest.fixture(scope="module")
def jax_full():
    """The JAX package's uninterrupted full-history sweep, in RAM."""
    return _jax(dict(keep_history="full"))


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    """(the port's uninterrupted summary-mode directory, its result)."""
    d = str(tmp_path_factory.mktemp("port-whole"))
    return d, _port(dict(keep_history="summary", results_dir=d))


# ---------------------------------------------------------------------------
# step checkpoints
# ---------------------------------------------------------------------------

def _random_bufs(seed: int, mode: str) -> dict:
    from repro_torch.core.genome import CGPSpec
    bufs = _alloc_buffers(CGPSpec(n_i=6, n_o=6, n_n=NODES), N_RUNS, GENS,
                          mode)
    rng = np.random.default_rng(seed)
    for k, v in bufs.items():
        v[...] = (rng.integers(0, 200, v.shape) if v.dtype.kind in "iu"
                  else rng.standard_normal(v.shape))
    return bufs


@pytest.mark.parametrize("mode", ["summary", "full"])
def test_checkpoints_interchange_with_the_reference(mode, tmp_path):
    bufs = _random_bufs(0, mode)
    assert sorted(bufs) == sorted(BUF_KEYS + (HIST_KEYS if mode == "full"
                                              else ()))
    meta = {"done": 2, "fingerprint": "f" * 64}
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    store.save_checkpoint(a, 2, bufs, meta)
    j_store.save_checkpoint(b, 2, bufs, meta)
    # the same files, byte for byte: leaf_<i> is the i-th key in sorted order
    files = sorted(os.listdir(os.path.join(a, "step_00000002")))
    assert files == sorted(os.listdir(os.path.join(b, "step_00000002")))
    for f in files:
        with open(os.path.join(a, "step_00000002", f), "rb") as fa, \
                open(os.path.join(b, "step_00000002", f), "rb") as fb:
            assert fa.read() == fb.read(), f
    for i, k in enumerate(sorted(bufs)):
        assert np.array_equal(
            np.load(os.path.join(a, "step_00000002", f"leaf_{i}.npy")),
            bufs[k]), k
    template = {k: np.zeros_like(v) for k, v in bufs.items()}
    for src in (a, b):   # each package loads both packages' checkpoints
        got, got_meta = store.load_checkpoint(src, 2, template)
        assert got_meta == meta == store.load_metadata(src, 2)
        want, _ = j_store.load_checkpoint(src, 2, template)
        assert list(got) == list(template)
        for k in bufs:
            assert isinstance(got[k], np.ndarray), k
            _assert_close(got[k], bufs[k], k)
            assert np.array_equal(np.asarray(want[k]), got[k]), k


def test_load_casts_to_the_template_and_checks_it(tmp_path):
    d = str(tmp_path)
    store.save_checkpoint(d, 5, {"b": np.arange(3, dtype=np.int64),
                                 "a": np.ones((2, 2), np.float64)})
    tree, meta = store.load_checkpoint(
        d, 5, {"a": np.zeros((2, 2), np.float32),
               "b": np.zeros(3, np.uint8)})
    assert meta == {} and tree["a"].dtype == np.float32
    assert tree["b"].dtype == np.uint8 and tree["b"].tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="leaves"):
        store.load_checkpoint(d, 5, {"a": np.zeros((2, 2))})
    with pytest.raises(ValueError, match="leaf 1"):
        store.load_checkpoint(d, 5, {"a": np.zeros((2, 2)),
                                     "b": np.zeros(4)})


def test_committed_steps_latest_and_cleanup(tmp_path):
    d = str(tmp_path)
    assert store.committed_steps(d + "/missing") == []
    assert store.latest_step(d) is None is j_store.latest_step(d)
    for step in (2, 4, 6, 8, 10):
        store.save_checkpoint(d, step, {"x": np.full(2, step)})
    os.makedirs(os.path.join(d, "step_00000012.tmp"))      # a save cut short
    os.makedirs(os.path.join(d, "step_00000014"))          # no commit marker
    assert store.committed_steps(d) == [2, 4, 6, 8, 10]
    assert store.committed_steps(d) == j_store.committed_steps(d)
    assert store.latest_step(d) == j_store.latest_step(d) == 10
    store.cleanup(d, keep=3)
    # the reference's rule: the newest 3 step directories stay, marked or not
    assert sorted(os.listdir(d)) == ["step_00000008", "step_00000010",
                                     "step_00000012.tmp", "step_00000014"]
    assert store.committed_steps(d) == [8, 10]


# ---------------------------------------------------------------------------
# shard resume across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_shard_resume_across_packages(first, second, jax_dir, tmp_path):
    d = str(tmp_path / "shards")
    part = RUN[first](dict(keep_history="summary", results_dir=d,
                           max_chunks=1))
    assert part.completed == CHUNK
    head = _mtimes(d)
    done = RUN[second](dict(keep_history="summary", results_dir=d))
    assert done.completed == N_RUNS and done.runs_per_sec > 0
    # the first package's shard and manifest were not written again
    assert {n: t for n, t in _mtimes(d).items() if n in head} == head
    got, want = _shard_arrays(d), _shard_arrays(jax_dir)
    assert got.keys() == want.keys()
    for key in want:
        _assert_close(got[key], want[key], key)
    rows = np.concatenate([v for (_, k), v in got.items()
                           if k == "grid_rows"])
    assert sorted(rows.tolist()) == list(range(N_RUNS))   # each row once
    for reader in (SweepResultReader(d), JReader(d)):
        assert reader.completed == N_RUNS
    # a rerun of the finished directory runs nothing and writes nothing
    before = _mtimes(d)
    again = _port(dict(keep_history="summary", results_dir=d))
    assert again.runs_per_sec == 0.0 and again.completed == N_RUNS
    assert _mtimes(d) == before
    for a, b in zip(again.records, done.records):
        assert np.array_equal(a.genome_nodes, b.genome_nodes)
        assert np.array_equal(a.metrics, b.metrics)


def test_max_chunks_counts_the_chunks_of_this_call(tmp_path, chunk_calls,
                                                   port_dir):
    d = str(tmp_path)
    for want in (CHUNK, N_RUNS, N_RUNS):
        res = _port(dict(keep_history="none", results_dir=d, max_chunks=1))
        assert res.completed == want and len(res.records) == want
    assert len(chunk_calls) == 2
    whole = port_dir[1]
    assert np.array_equal(res.metrics, whole.metrics)
    assert res.certified_mask.all()
    assert not res.metrics_stderr.any()


def test_full_mode_resume_restores_the_histories(tmp_path, chunk_calls):
    d = str(tmp_path)
    whole = _port(dict(keep_history="full"))
    _port(dict(keep_history="full", results_dir=d, max_chunks=1))
    res = _port(dict(keep_history="full", results_dir=d))
    assert len(chunk_calls) == 2 + 1 + 1
    for k in HIST_KEYS + ("metrics", "power_rel", "best_fit"):
        assert np.array_equal(getattr(res, k), getattr(whole, k)), k


# ---------------------------------------------------------------------------
# checkpoint resume across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax")])
def test_checkpoint_resume_across_packages(first, second, jax_full, tmp_path,
                                           chunk_calls):
    ck = str(tmp_path / "ck")
    # another grid's step, newer than this grid's, in the same directory:
    # never loaded (its shapes would not even fit)
    store.save_checkpoint(ck, 3, {"x": np.zeros(3)},
                          {"done": 3, "fingerprint": "0" * 64})
    part = RUN[first](dict(keep_history="full", checkpoint_dir=ck,
                           max_chunks=1, checkpoint_every=1))
    assert part.completed == CHUNK
    assert store.committed_steps(ck) == [2, 3]
    done = RUN[second](dict(keep_history="full", checkpoint_dir=ck))
    assert done.completed == N_RUNS and done.runs_per_sec > 0
    if second == "port":
        assert len(chunk_calls) == 1           # the restored chunk is skipped
    for k in ("metrics", "metrics_stderr", "power_rel", "feasible",
              "best_fit") + HIST_KEYS:
        _assert_close(getattr(done, k), getattr(jax_full, k), k)
    for a, b in zip(done.records, jax_full.records):
        assert np.array_equal(a.genome_nodes, b.genome_nodes)
        assert np.array_equal(a.genome_outs, b.genome_outs)
        _assert_close(a.metrics, b.metrics, "record metrics")
    assert store.committed_steps(ck) == [2, 3, N_RUNS]
    meta = store.load_metadata(ck, N_RUNS)
    assert meta["done"] == N_RUNS
    assert meta["fingerprint"] == store.load_metadata(ck, 2)["fingerprint"]
    # a rerun resumes from the last step and runs nothing
    again = _port(dict(keep_history="full", checkpoint_dir=ck))
    assert again.runs_per_sec == 0.0 and again.completed == N_RUNS
    assert np.array_equal(again.hist_fit, done.hist_fit)


def test_checkpoints_keep_three_and_every(tmp_path):
    ck = str(tmp_path)
    cfg = SearchConfig(width=2, kind="mul", n_n=20,
                       evolve=EvolveConfig(generations=5, lam=2))
    cons = [ConstraintSpec(mae=m) for m in (1.0, 2.0, 3.0, 4.0, 5.0)]
    run_sweep_batched(cfg, cons, (0,), SweepConfig(
        chunk_size=1, checkpoint_dir=ck, checkpoint_every=2,
        keep_history="none"), device="cpu")
    # steps 2 and 4 (every 2 chunks) and 5 (the end), all of them kept
    assert store.committed_steps(ck) == [2, 4, 5]
    shutil.rmtree(ck)
    run_sweep_batched(cfg, cons, (0,), SweepConfig(
        chunk_size=1, checkpoint_dir=ck, keep_history="none"), device="cpu")
    assert store.committed_steps(ck) == [3, 4, 5]
    with pytest.raises(ValueError, match="checkpoint_every"):
        SweepConfig(checkpoint_every=0)


@pytest.mark.parametrize("mode", [True, False, "none", "summary", "full",
                                  "some", 1])
def test_history_mode_normalization(mode):
    from repro.core.results import normalize_history_mode as j_normalize
    try:
        want = j_normalize(mode)
    except ValueError:
        with pytest.raises(ValueError, match="keep_history"):
            normalize_history_mode(mode)
    else:
        assert normalize_history_mode(mode) == want
    # the sweep's config takes the mode strings only
    if mode in ("none", "summary", "full"):
        assert SweepConfig(keep_history=mode).keep_history == mode
    else:
        with pytest.raises(ValueError, match="keep_history"):
            SweepConfig(keep_history=mode)


# ---------------------------------------------------------------------------
# quarantine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("damage", ["empty", "truncated"])
@pytest.mark.parametrize("which,reruns", [("last", 1), ("first", 2)])
def test_damaged_shard_is_quarantined_and_rerun(damage, which, reruns,
                                                port_dir, tmp_path, capsys,
                                                chunk_calls):
    d = str(tmp_path / "shards")
    shutil.copytree(port_dir[0], d)
    want = _shard_arrays(d)
    names = sorted(n for n in os.listdir(d) if n.startswith("shard_"))
    victim = os.path.join(d, names[-1 if which == "last" else 0])
    size = os.path.getsize(victim)
    with open(victim, "r+b") as f:
        f.truncate(0 if damage == "empty" else size // 2)
    res = _port(dict(keep_history="summary", results_dir=d))
    err = capsys.readouterr().err
    assert f"quarantined damaged shard {victim}" in err
    assert os.path.exists(victim + ".corrupt")
    assert len(chunk_calls) == reruns and res.completed == N_RUNS
    got = _shard_arrays(d)
    assert got.keys() == want.keys()
    for key in want:                  # the port reruns to the same bytes
        assert np.array_equal(got[key], want[key]), key


# ---------------------------------------------------------------------------
# old and multi-pod directories
# ---------------------------------------------------------------------------

def _downgrade_to_v2(results_dir):
    """A v3 directory rewritten as its v2 equivalent: no certified_mask
    column, the old version stamped."""
    man_path = os.path.join(results_dir, "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    man["schema_version"] = 2
    with open(man_path, "w") as f:
        json.dump(man, f)
    for name in os.listdir(results_dir):
        if name.startswith("shard_"):
            p = os.path.join(results_dir, name)
            with np.load(p) as z:
                data = {k: z[k] for k in z.files if k != "certified_mask"}
            np.savez(p, **data)


def test_v2_directory_reads_with_certified_zero(jax_dir, tmp_path):
    d = str(tmp_path / "v2")
    shutil.copytree(jax_dir, d)
    _downgrade_to_v2(d)
    got, want = SweepResultReader(d), JReader(d)
    assert got.schema_version == 2 and got.completed == N_RUNS
    s = got.summary()
    assert s["done_mask"].all() and not s["certified_mask"].any()
    for k, v in want.summary().items():
        assert np.array_equal(s[k], v), k
    assert not any(r.certified for r in got.records())
    for (span, rows), (wspan, wrows) in zip(got.iter_shards(),
                                            want.iter_shards()):
        assert span == wspan and "certified_mask" not in rows
        assert rows.keys() == wrows.keys()
    assert np.array_equal(got.correlations(), want.correlations())
    # a future version is still refused
    with open(os.path.join(d, "manifest.json")) as f:
        man = json.load(f)
    man["schema_version"] = 4
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="not readable"):
        SweepResultReader(d)


def test_two_pod_directory_reads_as_the_reference(tmp_path):
    d = str(tmp_path)
    pods = dict(keep_history="none", results_dir=d, n_pods=2)
    cfg = JSearchConfig(width=WIDTH, kind="mul", n_n=NODES,
                        evolve=JEvolveConfig(generations=GENS, lam=LAM))
    cons = [JConstraint(**c) for c in CONSTRAINTS]
    # chunks of 1: pod 0 owns chunks 0 and 2, pod 1 chunks 1 and 3; pod 1
    # stops after one, so the coverage has a hole at chunk 3
    j_run_sweep_batched(cfg, cons, SEEDS, JSweepConfig(chunk_size=1,
                                                       pod_index=0, **pods))
    j_run_sweep_batched(cfg, cons, SEEDS, JSweepConfig(
        chunk_size=1, pod_index=1, max_chunks=1, **pods))
    got, want = SweepResultReader(d), JReader(d)
    assert got.n_pods == 2 and got.spans() == want.spans() == [
        (0, 1), (1, 2), (2, 3)]
    assert got.completed == want.completed == 3
    s, w = got.summary(), want.summary()
    assert s.keys() == w.keys()
    for k in w:
        assert np.array_equal(s[k], w[k]), k
    assert np.array_equal(got.done_mask(), want.done_mask())
    for a, b in zip(got.records(), want.records()):
        assert (a.constraint, a.seed, a.power_rel) == (b.constraint, b.seed,
                                                       b.power_rel)
    assert all(np.array_equal(got.fronts()[i], want.fronts()[i])
               for i in want.fronts())
    # the port runs one pod: it reads this directory but does not extend it
    with pytest.raises(ValueError, match="n_pods"):
        _port(dict(keep_history="none", results_dir=d))


@pytest.mark.parametrize("plan,pods,want", [
    (None, 1, [(0, 2), (2, 4)]),
    ([(0, 2), (2, 4), (4, 6)], 1, [(0, 2), (2, 4)]),
    ([(0, 2), (2, 4), (4, 6), (6, 8)], 2, [(0, 2), (2, 4), (6, 8)]),
])
def test_coverage_rules(plan, pods, want):
    from repro.core import results as J
    committed = [(0, 2), (2, 4), (6, 8)]
    got = (_prefix_spans(committed) if plan is None
           else pod_prefix_spans(committed, plan, pods))
    ref = (J._prefix_spans(committed) if plan is None
           else J.pod_prefix_spans(committed, plan, pods))
    assert got == ref == want


# ---------------------------------------------------------------------------
# the writer's manifest against the reference writer's
# ---------------------------------------------------------------------------

PLAN = [(0, 2), (2, 4), (4, 6), (6, 8)]


def _writer_args(fingerprint="f" * 64, **kw) -> dict:
    return dict(grid_fingerprint=fingerprint,
                grid_meta=[{"constraint": "mae<=1%", "seed": i,
                            "gauss_sigma": 256.0} for i in range(8)],
                n_runs=8, gens=3, n_n=5, n_o=2, keep_history="none",
                chunk_size=2, chunk_spans=PLAN,
                problem_meta={"width": 3, "kind": "mul", "n_n": 5}, **kw)


def _write_zero_chunk(writer, span):
    rows = {k: np.zeros((span[1] - span[0],) + tuple(
        writer._dims[d] if isinstance(d, str) else d for d in shape), dtype)
        for k, (shape, dtype) in SUMMARY_FIELDS.items()}
    rows["grid_rows"] = np.arange(*span, dtype=np.int32)
    writer.write_chunk(span, rows)


def _manifest(d) -> dict:
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("n_pods,coverage", [(1, 4), (2, 6), (3, 6)])
def test_pod_spans_and_coverage_match_reference(n_pods, coverage, tmp_path):
    d = str(tmp_path)
    w = SweepResultWriter(d, **_writer_args(n_pods=n_pods))
    for span in [(0, 2), (2, 4), (6, 8)]:
        _write_zero_chunk(w, span)
    j = JWriter(d, **_writer_args(n_pods=n_pods))
    assert w.manifest == j.manifest == _manifest(d)
    for p in range(n_pods):
        assert w.pod_spans(p) == j.pod_spans(p) == PLAN[p::n_pods]
    assert w.live_spans() == j.live_spans()
    assert w.coverage() == j.coverage() == coverage


@pytest.mark.parametrize("dropped", [("n_pods", "chunk_spans", "problem"),
                                     ("problem",)])
def test_old_manifest_is_upgraded_as_the_reference(dropped, tmp_path):
    base = str(tmp_path / "base")
    w = SweepResultWriter(base, **_writer_args())
    for span in PLAN[:2]:
        _write_zero_chunk(w, span)
    whole = _manifest(base)
    old = {k: v for k, v in whole.items() if k not in dropped}
    with open(os.path.join(base, "manifest.json"), "w") as f:
        json.dump(old, f)
    files = sorted(os.listdir(base))
    got = {}
    for pkg, writer in (("port", SweepResultWriter), ("jax", JWriter)):
        d = str(tmp_path / pkg)
        shutil.copytree(base, d)
        got[pkg] = writer(d, **_writer_args()).live_spans()
        assert _manifest(d) == whole, pkg
        assert sorted(os.listdir(d)) == files, pkg
    assert got["port"] == got["jax"] == PLAN[:2]


def test_reset_empties_the_directory_as_the_reference(tmp_path):
    for pkg, writer in (("port", SweepResultWriter), ("jax", JWriter)):
        d = str(tmp_path / pkg)
        _write_zero_chunk(writer(d, **_writer_args()), PLAN[0])
        os.makedirs(os.path.join(d, "stray"))
        with pytest.raises(ValueError, match="different sweep"):
            writer(d, **_writer_args("e" * 64))
        assert len(os.listdir(d)) == 3, pkg       # a refusal keeps it all
        w = writer(d, **_writer_args("e" * 64), on_mismatch="reset")
        assert os.listdir(d) == ["manifest.json"], pkg
        assert w.live_spans() == [] and w.coverage() == 0, pkg
    assert _manifest(str(tmp_path / "port")) == \
        _manifest(str(tmp_path / "jax"))


@pytest.mark.parametrize("caps", [{}, {"mae": 1.0}, {"wce": 5.0, "er": 50.0},
                                  {"acc0": 1.0}])
def test_library_matches_reference(caps, port_dir, tmp_path):
    from repro.core import library as j_library
    from repro_torch.core import library
    _, res = port_dir
    paths = [str(tmp_path / "port.json"), str(tmp_path / "jax.json")]
    library.save_library(res.records, paths[0])
    j_library.save_library(res.records, paths[1])
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    lib = library.load_library(paths[0])
    assert lib == j_library.load_library(paths[1]) and len(lib) == N_RUNS
    for rec in lib:
        g, j = library.record_to_genome(rec, "cpu"), \
            j_library.record_to_genome(rec)
        for got, want in ((g.nodes, j.nodes), (g.outs, j.outs)):
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            assert np.array_equal(got.numpy(), np.asarray(want))
    assert library.select_best(lib, **caps) == \
        j_library.select_best(lib, **caps)


# ---------------------------------------------------------------------------
# the Pareto feeds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feasible_only", [True, False])
@pytest.mark.parametrize("indices", [(M.MAE, M.ER), tuple(range(7))])
def test_reader_analyses_match_reference_and_in_ram(feasible_only, indices,
                                                    port_dir, jax_dir):
    d, res = port_dir
    got = SweepResultReader(d)
    for reader in (JReader(d), JReader(jax_dir)):
        # the JAX reader on the same directory, and on its own directory
        # (its float columns within rtol)
        want_c = reader.correlations(feasible_only)
        want_f = reader.fronts(indices, feasible_only)
        if reader.results_dir == d:
            assert np.array_equal(got.correlations(feasible_only), want_c)
            for i in indices:
                assert np.array_equal(got.fronts(indices, feasible_only)[i],
                                      want_f[i])
        else:
            np.testing.assert_allclose(got.correlations(feasible_only),
                                       want_c, rtol=1e-5)
    assert np.array_equal(got.correlations(feasible_only),
                          res.correlations(feasible_only))
    fronts = res.fronts(indices, feasible_only)
    assert list(fronts) == list(indices)
    for i, front in got.fronts(indices, feasible_only).items():
        assert np.array_equal(front, fronts[i]), i


# ---------------------------------------------------------------------------
# resume under model_axis
# ---------------------------------------------------------------------------

def _resume_rank(rank, world, results_dir, ckpt_dir):
    """Both resumes under ``model_axis``; returns what each rank ran and
    got."""
    from repro_torch.launch.mesh import make_sweep_mesh
    from repro_torch.parallel import ctx
    torch.set_num_threads(1)
    calls = []
    real = sweep_mod.evolve_chunk
    sweep_mod.evolve_chunk = lambda *a, **k: calls.append(1) or real(*a, **k)
    mesh = make_sweep_mesh(pods=1, device="cpu")
    out = []
    with ctx.use_mesh(mesh):
        for sweep in (dict(keep_history="summary", results_dir=results_dir),
                      dict(keep_history="full", checkpoint_dir=ckpt_dir)):
            del calls[:]
            res = _port(dict(model_axis="model", **sweep))
            out.append((len(calls), res.completed,
                        [(r.genome_nodes, r.metrics) for r in res.records],
                        res.hist_fit))
    return out


def test_model_axis_resume_gives_the_unsharded_run(port_dir, tmp_path):
    from repro_torch.parallel.spawn import run_ranks
    whole_dir, whole = port_dir
    rd, ck = str(tmp_path / "shards"), str(tmp_path / "ck")
    _port(dict(keep_history="summary", results_dir=rd, max_chunks=1))
    _port(dict(keep_history="full", checkpoint_dir=ck, max_chunks=1))
    full = _port(dict(keep_history="full"))
    outs = run_ranks(_resume_rank, 2, rd, ck, timeout_s=240.0,
                     workdir=str(tmp_path))
    for rank_out in outs:
        for leg, (calls, completed, records, hist_fit) in enumerate(rank_out):
            assert calls == 1 and completed == N_RUNS, leg
            for (nodes, met), r in zip(records, whole.records):
                assert np.array_equal(nodes, r.genome_nodes)
                assert np.array_equal(met, r.metrics)
            if leg == 1:
                assert np.array_equal(hist_fit, full.hist_fit)
    # one writer: the unsharded run's shards, the histories' MRE column
    # aside (summed per slice in float32)
    got, want = _shard_arrays(rd), _shard_arrays(whole_dir)
    assert got.keys() == want.keys()
    for key in want:
        if key[1] == "hist_metrics":
            mre = np.arange(7) == M.MRE
            assert np.array_equal(got[key][..., ~mre], want[key][..., ~mre])
            _assert_close(got[key], want[key], key)
        else:
            assert np.array_equal(got[key], want[key]), key
    assert store.committed_steps(ck) == [CHUNK, N_RUNS]


# ---------------------------------------------------------------------------
# the CLI and the examples
# ---------------------------------------------------------------------------

CLI = ["--width", "3", "--kind", "mul", "--nodes", "60", "--constraint",
       "mae=1.0", "--constraint", "wce=5", "--generations", "40", "--lam",
       "4", "--seeds", "2", "--chunk-size", "2", "--no-history"]


def _assert_library_row(got: dict, want: dict):
    """Every field of a library row: integers, bools and strings exact,
    floats within rtol."""
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if isinstance(w, dict):
            _assert_library_row(g, w)
        elif isinstance(w, float):
            assert isinstance(g, float), key
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=key)
        else:
            assert type(g) is type(w) and g == w, key


def _rows(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def test_cli_checkpoint_out_and_no_history(tmp_path, capsys, monkeypatch):
    paths = {p: (str(tmp_path / p / "ck"), str(tmp_path / p / "lib.json"))
             for p in ("jax", "port")}
    ck, lib = paths["jax"]
    monkeypatch.setattr(sys, "argv", ["repro.launch.evolve", *CLI,
                                      "--checkpoint-dir", ck, "--out", lib])
    j_evolve.main()
    want = capsys.readouterr().out
    ck, lib = paths["port"]
    args = CLI + ["--checkpoint-dir", ck, "--out", lib, "--device", "cpu"]
    t_evolve.main(args)
    got = capsys.readouterr().out
    assert _rows(got) == _rows(want) and len(_rows(got)) == N_RUNS
    assert f"[evolve] wrote {N_RUNS} circuits -> {lib}" in got
    libs = [json.load(open(paths[p][1])) for p in ("jax", "port")]
    assert len(libs[0]) == len(libs[1]) == N_RUNS
    for j_row, t_row in zip(*libs):
        _assert_library_row(t_row, j_row)
    # --no-history: the checkpoints hold no histories, as the reference's
    manifests = []
    for p in ("jax", "port"):
        with open(os.path.join(paths[p][0], "step_00000004",
                               "manifest.json")) as f:
            manifests.append(json.load(f))
    assert manifests[0]["n_leaves"] == manifests[1]["n_leaves"] == 12
    assert manifests[0]["leaves"] == manifests[1]["leaves"]
    assert manifests[0]["metadata"] == manifests[1]["metadata"]
    # a rerun resumes the finished grid
    t_evolve.main(args)
    again = capsys.readouterr().out
    assert f"[evolve] {N_RUNS}/{N_RUNS} runs @ 0.00 runs/s" in again
    assert _rows(again) == _rows(got)


def _example(name):
    return runpy.run_path(os.path.join(REPO, "examples", name),
                          run_name="example")["main"]


def test_pareto_example_prints_fronts_and_resumes(tmp_path, capsys):
    main = _example("pareto_sweep_torch.py")
    args = ["--width", "2", "--gens", "20", "--seeds", "1", "--device", "cpu"]
    main(args)
    plain = capsys.readouterr().out
    assert "=== power vs MAE% Pareto fronts ===" in plain
    assert "=== power vs ER% Pareto fronts ===" in plain
    fronts = [line for line in plain.splitlines()
              if line.startswith(("mae-only", "er-only", "er+mae"))]
    assert len(fronts) == 6 and all("(" in line for line in fronts)
    args += ["--results-dir", str(tmp_path / "r"), "--checkpoint-dir",
             str(tmp_path / "c")]
    main(args)
    first = capsys.readouterr().out
    main(args)
    again = capsys.readouterr().out
    assert again.count("@ 0.00 runs/s") == 3
    pick = lambda out: [l for l in out.splitlines() if l[:1] != "["]
    assert pick(first) == pick(again) == pick(plain)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--width", "2", "--gens", "2", "--seeds", "1"])


def test_quickstart_example(capsys):
    from repro.core.search import run_search as j_run_search
    from repro_torch.core.search import run_search
    main = _example("quickstart_torch.py")
    main(["--generations", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "power trajectory (every 2 gens)" in out
    # the example's search is the reference quickstart's at 16 generations
    kw = dict(width=4, n_n=150)
    con = dict(mae=1.0, er=60.0)
    rec, _ = run_search(SearchConfig(**kw, evolve=EvolveConfig(
        generations=16, lam=8)), ConstraintSpec(**con), seed=0, device="cpu")
    want, _ = j_run_search(JSearchConfig(**kw, evolve=JEvolveConfig(
        generations=16, lam=8, seed=0)), JConstraint(**con), seed=0)
    assert rec.feasible == want.feasible
    assert np.array_equal(rec.genome_nodes, np.asarray(want.genome_nodes))
    np.testing.assert_allclose(rec.power_rel, want.power_rel, rtol=RTOL)
    _assert_close(rec.metrics, np.asarray(want.metrics), "metrics")
    assert f"feasible:        {rec.feasible}" in out
    assert f"relative power:  {rec.power_rel:.3f}" in out
    assert f"MAE%     {rec.metrics[M.MAE]:.4f}" in out
