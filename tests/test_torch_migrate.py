"""Pods, background commits and chunk-level migration: the port against
the JAX package on the CPU (the reference's ``test_async_sweep.py`` and
``test_pod_sweep.py``, run on the port).

Within the port every execution knob is byte-neutral: background commits,
pods and their order give the same shard, manifest and migrant bytes.
Across packages the manifests, file names, genomes and integer columns are
identical and the float columns (power, MRE: float32 sums taken in
another order) agree within rtol 1e-6 -- including a two-pod migrating
sweep whose pod 0 is the JAX package's and pod 1 the port's.
"""
import dataclasses
import json
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import migrate as j_migrate
from repro.core.commit import ChunkCommitter as JChunkCommitter
from repro.core.evolve import EvolveConfig as JEvolveConfig
from repro.core.evolve import EvolveState as JEvolveState
from repro.core.fitness import ConstraintSpec as JConstraint
from repro.core.genome import CGPSpec as JCGPSpec
from repro.core.genome import Genome as JGenome
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.sweep import SweepConfig as JSweepConfig
from repro.core.sweep import grid_fingerprint as j_grid_fingerprint
from repro.core.sweep import run_sweep_batched as j_run_sweep_batched
from repro.core.sweep import sweep_grid as j_sweep_grid
from repro_torch.core import migrate as migrate_mod
from repro_torch.core.commit import ChunkCommitter
from repro_torch.core.evolve import EvolveConfig, EvolveState
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.genome import CGPSpec, Genome
from repro_torch.core.results import SweepResultReader, SweepResultWriter
from repro_torch.core.search import SearchConfig
from repro_torch.core.sweep import (SweepConfig, grid_fingerprint,
                                    run_sweep_batched, sweep_grid)

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RTOL = 1e-6
CONSTRAINTS = [dict(mae=1.0), dict(mae=2.0), dict(er=50.0)]
SEEDS = (0, 1)
N_RUNS = len(CONSTRAINTS) * len(SEEDS)   # chunks of 2: three chunks
WIDTH, KIND, NODES, GENS, LAM = 2, "add", 40, 40, 3
SAMPLED = dict(eval_mode="sampled", sample_size=256, certify=True,
               certify_budget=2)
MIGRATE = dict(migrate_every=1, migrate_timeout=30.0)


def _cfgs(**evolve_kw):
    kw = dict(generations=GENS, lam=LAM, **evolve_kw)
    return (SearchConfig(width=WIDTH, kind=KIND, n_n=NODES,
                         evolve=EvolveConfig(**kw)),
            JSearchConfig(width=WIDTH, kind=KIND, n_n=NODES,
                          evolve=JEvolveConfig(**kw)))


def _port(results_dir, evolve_kw=None, **kw):
    sweep = SweepConfig(chunk_size=2, keep_history="summary",
                        results_dir=str(results_dir), **kw)
    return run_sweep_batched(_cfgs(**(evolve_kw or {}))[0],
                             [ConstraintSpec(**c) for c in CONSTRAINTS],
                             SEEDS, sweep, device="cpu")


def _jax(results_dir, evolve_kw=None, **kw):
    sweep = JSweepConfig(chunk_size=2, keep_history="summary",
                         results_dir=str(results_dir), **kw)
    return j_run_sweep_batched(_cfgs(**(evolve_kw or {}))[1],
                               [JConstraint(**c) for c in CONSTRAINTS],
                               SEEDS, sweep)


RUN = {"port": _port, "jax": _jax}


def _dir_bytes(d, prefix=("shard_", "migrants_", "manifest")):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d)) if f.startswith(prefix)}


def _assert_dirs_identical(a, b, prefix=("shard_", "migrants_",
                                         "manifest")):
    da, db = _dir_bytes(str(a), prefix), _dir_bytes(str(b), prefix)
    assert sorted(da) == sorted(db) and da
    for name in da:
        assert da[name] == db[name], f"bytes differ: {name}"


def _assert_dirs_match(got, want):
    """A directory of the port against one of the JAX package: the same
    files, manifests byte for byte, and in every ``.npz`` the same arrays
    in the same order, integer arrays bit for bit and float arrays within
    RTOL."""
    da, db = _dir_bytes(str(got)), _dir_bytes(str(want))
    assert sorted(da) == sorted(db) and da
    for name in da:
        if not name.endswith(".npz"):
            assert da[name] == db[name], name
            continue
        with np.load(os.path.join(got, name)) as za, \
                np.load(os.path.join(want, name)) as zb:
            assert za.files == zb.files, name
            for k in za.files:
                a, b = za[k], zb[k]
                assert a.dtype == b.dtype and a.shape == b.shape, (name, k)
                if a.dtype.kind == "f":
                    np.testing.assert_allclose(a, b, rtol=RTOL,
                                               err_msg=f"{name} {k}")
                else:
                    assert np.array_equal(a, b), (name, k)


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """The JAX package's reference directories: one pod, synchronous; a
    single-pod migrating sweep; a two-pod migrating sweep."""
    d = {k: tmp_path_factory.mktemp(f"jax-{k}")
         for k in ("plain", "migrate", "pods")}
    assert _jax(d["plain"]).completed == N_RUNS
    assert _jax(d["migrate"], **MIGRATE).completed == N_RUNS
    _two_pods(d["pods"], (RUN["jax"], RUN["jax"]), (0, 1))
    return d


@pytest.fixture(scope="module")
def port_plain(tmp_path_factory):
    d = tmp_path_factory.mktemp("port-plain")
    res = _port(d)
    assert res.completed == N_RUNS
    return d, res


# ---------------------------------------------------------------------------
# background commits: execution-only
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dedup", [False, True])
def test_async_commit_bit_identical(tmp_path, dedup, port_plain, jax_dirs):
    sync_d, async_d = tmp_path / "sync", tmp_path / "async"
    r_sync = _port(sync_d, dedup=dedup or None)
    r_async = _port(async_d, dedup=dedup or None, async_commit=True)
    assert r_sync.completed == r_async.completed == N_RUNS
    _assert_dirs_identical(sync_d, async_d)
    _assert_dirs_identical(async_d, port_plain[0])
    sa = SweepResultReader(str(sync_d)).summary()
    sb = SweepResultReader(str(async_d)).summary()
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key])
    _assert_dirs_match(async_d, jax_dirs["plain"])


def test_async_commit_sampled_certify_bit_identical(tmp_path):
    r_sync = _port(tmp_path / "sync", SAMPLED)
    r_async = _port(tmp_path / "async", SAMPLED, async_commit=True,
                    dedup=True)
    assert r_sync.certify_stats == r_async.certify_stats
    assert r_sync.certify_stats["escalated"] > 0
    _assert_dirs_identical(tmp_path / "sync", tmp_path / "async")


def test_async_commit_checkpoint_resume(tmp_path, port_plain):
    ck = str(tmp_path / "ck")
    sweep = SweepConfig(chunk_size=2, keep_history="summary",
                        checkpoint_dir=ck, async_commit=True)
    cfg, cons = _cfgs()[0], [ConstraintSpec(**c) for c in CONSTRAINTS]
    part = run_sweep_batched(cfg, cons, SEEDS,
                             dataclasses.replace(sweep, max_chunks=2),
                             device="cpu")
    assert 0 < part.completed < N_RUNS
    full = run_sweep_batched(cfg, cons, SEEDS, sweep, device="cpu")
    assert full.completed == N_RUNS
    want = port_plain[1]
    for key in ("metrics", "power_rel", "feasible", "best_fit"):
        np.testing.assert_array_equal(getattr(full, key), getattr(want, key))
    # the worker's checkpoints are the synchronous path's, byte for byte
    ck_sync = str(tmp_path / "ck_sync")
    run_sweep_batched(cfg, cons, SEEDS, dataclasses.replace(
        sweep, checkpoint_dir=ck_sync, async_commit=False), device="cpu")
    for step in sorted(os.listdir(ck)):
        for name in sorted(os.listdir(os.path.join(ck, step))):
            assert open(os.path.join(ck, step, name), "rb").read() == open(
                os.path.join(ck_sync, step, name), "rb").read()


@pytest.mark.parametrize("config", [SweepConfig, JSweepConfig])
def test_commit_depth_validated(config):
    with pytest.raises(ValueError, match="commit_depth"):
        config(commit_depth=0)


def test_committer_runs_in_order_and_drains():
    done, gate = [], threading.Event()

    def commit(i):
        gate.wait(5)
        done.append(i)

    with ChunkCommitter(max_pending=2) as c:
        for i in range(2):
            c.submit(commit, i)
        gate.set()
        for i in range(2, 6):
            c.submit(commit, i)
    assert done == list(range(6)) and c.committed == 6 and c.dropped == 0
    with pytest.raises(RuntimeError, match="closed"):
        c.submit(commit, 7)
    with pytest.raises(ValueError, match="max_pending"):
        ChunkCommitter(0)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_committer_failure_poisons_the_queue(package):
    cls = {"port": ChunkCommitter, "jax": JChunkCommitter}[package]
    ran, gate = [], threading.Event()

    def commit(i):
        gate.wait(5)
        if i == 1:
            raise OSError("disk gone")
        ran.append(i)

    c = cls(max_pending=4)
    for i in range(4):
        c.submit(commit, i)
    gate.set()
    with pytest.raises(OSError, match="disk gone"):
        c.drain()
    assert ran == [0] and (c.committed, c.dropped) == (1, 2)
    with pytest.raises(OSError, match="disk gone"):
        c.submit(commit, 9)           # re-raised before anything queues
    c.close(raise_errors=False)


def test_committer_drains_on_keyboard_interrupt():
    done = []
    with pytest.raises(KeyboardInterrupt):
        with ChunkCommitter(max_pending=3) as c:
            for i in range(3):
                c.submit(lambda i=i: done.append(i))
            raise KeyboardInterrupt
    assert done == [0, 1, 2]


# ---------------------------------------------------------------------------
# pods
# ---------------------------------------------------------------------------

def test_two_pods_give_the_one_pod_shards(tmp_path, port_plain, jax_dirs):
    p0 = _port(tmp_path, n_pods=2, pod_index=0)
    assert 0 < p0.completed < N_RUNS   # pod 0 owns chunks 0 and 2
    assert p0.done_mask.sum() == p0.completed
    p1 = _port(tmp_path, n_pods=2, pod_index=1)
    assert p1.completed == N_RUNS and p1.done_mask.all()
    _assert_dirs_identical(tmp_path, port_plain[0], ("shard_",))
    ra = SweepResultReader(str(port_plain[0]))
    rb = SweepResultReader(str(tmp_path))
    assert rb.n_pods == 2 and rb.completed == N_RUNS
    sa, sb = ra.summary(), rb.summary()
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key])
    for (rowa, ha), (rowb, hb) in zip(ra.iter_history(), rb.iter_history()):
        np.testing.assert_array_equal(rowa, rowb)
        for k in ha:
            np.testing.assert_array_equal(ha[k], hb[k])
    np.testing.assert_array_equal(p1.metrics, port_plain[1].metrics)


@pytest.mark.parametrize("pod_of", [("jax", "port"), ("port", "jax")])
def test_two_pods_of_either_package(tmp_path, jax_dirs, pod_of):
    """One pod per package against one directory: the JAX package's
    one-pod shards (and a manifest that pins two pods)."""
    for pod in (0, 1):
        RUN[pod_of[pod]](tmp_path, n_pods=2, pod_index=pod)
    with open(tmp_path / "manifest.json") as f:
        assert json.load(f)["n_pods"] == 2
    _assert_dirs_match_prefix(tmp_path, jax_dirs["plain"], ("shard_",))


def _assert_dirs_match_prefix(got, want, prefix):
    da, db = _dir_bytes(str(got), prefix), _dir_bytes(str(want), prefix)
    assert sorted(da) == sorted(db) and da
    for name in da:
        with np.load(os.path.join(got, name)) as za, \
                np.load(os.path.join(want, name)) as zb:
            assert za.files == zb.files
            for k in za.files:
                if za[k].dtype.kind == "f":
                    np.testing.assert_allclose(za[k], zb[k], rtol=RTOL)
                else:
                    assert np.array_equal(za[k], zb[k]), (name, k)


def test_pod_resume_from_partial_pod_prefixes(tmp_path, port_plain):
    p1 = _port(tmp_path, n_pods=2, pod_index=1)  # chunk 1 only: rows 2:4
    assert p1.completed == 2
    reader = SweepResultReader(str(tmp_path))
    assert reader.spans() == [(2, 4)] and reader.completed == 2
    again = _port(tmp_path, n_pods=2, pod_index=1)
    assert again.runs_per_sec == 0.0  # nothing left in pod 1's slice
    part0 = _port(tmp_path, n_pods=2, pod_index=0, max_chunks=1)
    assert part0.completed == 4       # pod 1's chunk and pod 0's first
    full = _port(tmp_path, n_pods=2, pod_index=0)
    assert full.completed == N_RUNS and full.done_mask.all()
    np.testing.assert_array_equal(full.metrics, port_plain[1].metrics)
    _assert_dirs_identical(tmp_path, port_plain[0], ("shard_",))


def test_pod_result_covers_other_pods_restored_rows(tmp_path, port_plain):
    _port(tmp_path, n_pods=2, pod_index=0)
    p1 = _port(tmp_path, n_pods=2, pod_index=1)
    assert p1.completed == N_RUNS
    np.testing.assert_array_equal(p1.metrics, port_plain[1].metrics)
    np.testing.assert_array_equal(p1.feasible, port_plain[1].feasible)


POD_GUARDS = {
    "results_dir": dict(n_pods=2),
    "checkpoint_dir": dict(n_pods=2, results_dir="R", checkpoint_dir="C"),
    "pod_index": dict(n_pods=2, results_dir="R", pod_index=2),
    "n_pods": dict(n_pods=0),
}


@pytest.mark.parametrize("match", sorted(POD_GUARDS))
def test_multi_pod_config_guards(match):
    for config in (SweepConfig, JSweepConfig):
        with pytest.raises(ValueError, match=match):
            config(**POD_GUARDS[match])


def test_pod_count_mismatch_refused(tmp_path):
    _port(tmp_path, n_pods=2, pod_index=0)
    with pytest.raises(ValueError, match="n_pods"):
        _port(tmp_path)               # one pod against a two-pod directory


def test_writer_pod_spans_filter(tmp_path):
    w = SweepResultWriter(str(tmp_path), grid_fingerprint="fp", grid_meta=[],
                          n_runs=4, gens=8, n_n=10, n_o=4,
                          keep_history="none", chunk_size=2, n_pods=2,
                          chunk_spans=[(0, 2), (2, 4)])
    assert w.pod_spans(0) == [(0, 2)] and w.pod_spans(1) == [(2, 4)]


# ---------------------------------------------------------------------------
# migration: off is byte-identical, on is deterministic
# ---------------------------------------------------------------------------

def _migrate_key(n_pods=1):
    return {"every": 1, "n_pods": n_pods, "chunk_size": 2,
            "top_k": migrate_mod.MIGRATE_TOP_K}


def test_migration_off_fingerprint_and_bytes_unchanged(tmp_path,
                                                       port_plain):
    tcfg, jcfg = _cfgs()
    grid = sweep_grid([ConstraintSpec(**c) for c in CONSTRAINTS], SEEDS)
    jgrid = j_sweep_grid([JConstraint(**c) for c in CONSTRAINTS], SEEDS)
    base = grid_fingerprint(tcfg, grid, "summary")
    assert grid_fingerprint(tcfg, grid, "summary", migrate=None) == base
    assert base == j_grid_fingerprint(jcfg, jgrid, "summary")
    for n_pods in (1, 2):
        on = grid_fingerprint(tcfg, grid, "summary",
                              migrate=_migrate_key(n_pods))
        assert on != base
        assert on == j_grid_fingerprint(jcfg, jgrid, "summary",
                                        migrate=_migrate_key(n_pods))
    _port(tmp_path, migrate_every=0)
    _assert_dirs_identical(tmp_path, port_plain[0])
    with open(tmp_path / "manifest.json") as f:
        assert json.load(f)["grid_fingerprint"] == base


MIGRATE_GUARDS = {
    "results_dir": dict(migrate_every=1),
    "model_axis": dict(migrate_every=1, results_dir="R", model_axis="model"),
    "migrate_every": dict(migrate_every=-1),
}


@pytest.mark.parametrize("match", sorted(MIGRATE_GUARDS))
def test_migration_config_validated(match):
    for config in (SweepConfig, JSweepConfig):
        with pytest.raises(ValueError, match=match):
            config(**MIGRATE_GUARDS[match])


def test_migration_single_pod_deterministic(tmp_path, jax_dirs):
    r1 = _port(tmp_path / "a", **MIGRATE)
    r2 = _port(tmp_path / "b", **MIGRATE)
    assert r1.completed == r2.completed == N_RUNS
    _assert_dirs_identical(tmp_path / "a", tmp_path / "b")
    assert r1.migrate_stats == r2.migrate_stats
    assert r1.migrate_stats["published"] == 3  # 3 chunks, period 1
    assert r1.migrate_stats["imported"] > 0
    _assert_dirs_match(tmp_path / "a", jax_dirs["migrate"])


def test_migration_compose_dedup_bit_identical(tmp_path):
    _port(tmp_path / "plain", **MIGRATE)
    res = _port(tmp_path / "dedup", dedup=True, **MIGRATE)
    assert res.dedup_stats["hit_rate"] > 0
    _assert_dirs_identical(tmp_path / "plain", tmp_path / "dedup")


def _two_pods(d, runs, order, **kw):
    """A two-pod migrating sweep interleaved in one process, one epoch a
    call (max_chunks == period), pod p run by ``runs[p]``, the pods taking
    turns in ``order``."""
    done = {}
    for _ in range(4):  # chunks split [2, 1]: at most 4 one-epoch calls
        for pod in order:
            done[pod] = runs[pod](d, n_pods=2, pod_index=pod, max_chunks=1,
                                  **MIGRATE, **kw)
            if len(done) == 2 and all(r.completed == N_RUNS
                                      for r in done.values()):
                return done
    return done


def test_migration_two_pods_pod_order_independent(tmp_path, jax_dirs):
    a = _two_pods(tmp_path / "p01", (_port, _port), (0, 1))
    b = _two_pods(tmp_path / "p10", (_port, _port), (1, 0))
    assert a[0].completed == N_RUNS and b[0].completed == N_RUNS
    _assert_dirs_identical(tmp_path / "p01", tmp_path / "p10")
    names = os.listdir(tmp_path / "p01")
    assert any(n.startswith("migrants_pod0_") for n in names)
    assert any(n.startswith("migrants_pod1_") for n in names)
    _assert_dirs_match(tmp_path / "p01", jax_dirs["pods"])


@pytest.mark.parametrize("order", [(0, 1), (1, 0)])
def test_migration_two_pods_across_packages(tmp_path, jax_dirs, order):
    """Pod 0 run by the JAX package, pod 1 by the port: the all-JAX
    two-pod sweep's files."""
    res = _two_pods(tmp_path, (_jax, _port), order)
    assert res[0].completed == N_RUNS
    _assert_dirs_match(tmp_path, jax_dirs["pods"])


@pytest.mark.parametrize("package", ["port", "jax"])
def test_migration_missing_peer_times_out(tmp_path, package):
    # pod 0 owns plan positions {0, 1}: position 1 is epoch 1 and waits
    # for pod 1's epoch-0 file, which nobody writes
    with pytest.raises(RuntimeError, match="migrant file"):
        RUN[package](tmp_path, pod_index=0, n_pods=2, migrate_every=1,
                     migrate_timeout=0.3)


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_migration_rejects_foreign_fingerprint(tmp_path, writer, reader):
    mods = {"port": migrate_mod, "jax": j_migrate}
    mods[writer].MigrationManager(
        str(tmp_path), pod=1, pod_lens=[2, 2], period=1,
        fingerprint="aaaa").maybe_publish(0, {
            "sigma": np.zeros((0,), np.float32),
            "nodes": np.zeros((0, 4, 3), np.int32),
            "outs": np.zeros((0, 2), np.int32),
            "power_rel": np.zeros((0,), np.float32),
            "digest": np.zeros((0, 16), np.uint8)})
    # pod_lens [0, 2]: only pod 1 publishes epoch 0, so the reader goes
    # straight to the stale file
    mgr = mods[reader].MigrationManager(str(tmp_path), pod=0,
                                        pod_lens=[0, 2], period=1,
                                        fingerprint="bbbb", timeout=1.0)
    with pytest.raises(ValueError, match="fingerprint"):
        mgr.candidates(0, 0.0)


# ---------------------------------------------------------------------------
# the migration pieces against the reference's
# ---------------------------------------------------------------------------

def _rows(rng, spec, n, sigmas=(256.0, 3.0)):
    """``n`` committed rows: genomes (repeating some), powers with ties,
    feasibility and σ."""
    hi = spec.n_i + np.arange(spec.n_n)
    nodes = np.stack([rng.integers(0, hi, (n, spec.n_n)),
                      rng.integers(0, hi, (n, spec.n_n)),
                      rng.integers(0, spec.n_funcs, (n, spec.n_n))],
                     axis=-1).astype(np.int32)
    outs = rng.integers(0, spec.n_wires, (n, spec.n_o)).astype(np.int32)
    nodes[1::5], outs[1::5] = nodes[0], outs[0]          # duplicates
    power = rng.choice([0.5, 0.75, 0.8, 1.0], n).astype(np.float32)
    feas = rng.random(n) < 0.7
    sig = np.asarray(sigmas, np.float32)[rng.integers(0, len(sigmas), n)]
    return nodes, outs, power, feas, sig


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_elites_and_migrant_files_match_reference(tmp_path, seed):
    spec = CGPSpec(n_i=4, n_o=3, n_n=12)
    jspec = JCGPSpec(n_i=4, n_o=3, n_n=12)
    rows = _rows(np.random.default_rng(seed), spec, 40)
    got = migrate_mod.select_elites(*rows, spec)
    want = j_migrate.select_elites(*rows, jspec)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    paths = []
    for mod, sub in ((migrate_mod, "port"), (j_migrate, "jax")):
        os.makedirs(tmp_path / sub)
        mgr = mod.MigrationManager(str(tmp_path / sub), pod=1,
                                   pod_lens=[3, 2], period=2,
                                   fingerprint="f" * 64)
        paths.append(mgr.maybe_publish(0, got))
        assert mgr.maybe_publish(0, got) is None   # present: no rewrite
        assert (mgr.publishes_at(0), mgr.publishes_at(1),
                mgr.publishers(0), mgr.publishers(1)) == (None, 0, [0, 1],
                                                          [])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    for sigma in (256.0, 3.0, 7.0):
        # each package imports the file the other one wrote
        mgrs = [mod.MigrationManager(str(tmp_path / sub), pod=0,
                                     pod_lens=[0, 2], period=2,
                                     fingerprint="f" * 64)
                for mod, sub in ((migrate_mod, "jax"), (j_migrate, "port"))]
        a, b = (m.candidates(0, sigma) for m in mgrs)
        assert (a is None) == (b is None)
        if a is not None:
            assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("seed", [0, 1])
def test_fold_segment_matches_reference(seed):
    rng = np.random.default_rng(seed)
    C, Mp, n_n, n_o = 6, 4, 5, 2
    spec = JCGPSpec(n_i=4, n_o=n_o, n_n=n_n)
    nodes = rng.integers(0, 4, (C, n_n, 3)).astype(np.int32)
    outs = rng.integers(0, 4, (C, n_o)).astype(np.int32)
    fit = rng.choice([0.6, 0.8, np.inf], C).astype(np.float32)
    met = rng.random((C, 7)).astype(np.float32)
    power = rng.random(C).astype(np.float32)
    keys = rng.integers(0, 2 ** 31, (C, 2)).astype(np.uint32)
    mn = rng.integers(0, 4, (Mp, n_n, 3)).astype(np.int32)
    mo = rng.integers(0, 4, (Mp, n_o)).astype(np.int32)
    mmv = rng.random((Mp, 7)).astype(np.float32) * 3
    mpw = np.array([0.7, 0.6, 0.6, 0.9], np.float32)
    thr = np.full((C, 7), np.inf, np.float32)
    thr[:, 5:] = -np.inf
    thr[::2, 0] = 1.5
    jstate = JEvolveState(JGenome(jnp.asarray(nodes), jnp.asarray(outs)),
                          jnp.asarray(fit), jnp.asarray(met),
                          jnp.asarray(power),
                          JGenome(jnp.asarray(nodes), jnp.asarray(outs)),
                          jnp.asarray(fit), jnp.asarray(keys))
    jout, jn = j_migrate.fold_segment(
        spec, JEvolveConfig(), jstate, jnp.asarray(mn), jnp.asarray(mo),
        jnp.asarray(mmv), jnp.asarray(mpw), jnp.asarray(thr))
    t = torch.as_tensor
    tstate = EvolveState(Genome(t(nodes), t(outs)), t(fit), t(met), t(power),
                         Genome(t(nodes), t(outs)), t(fit),
                         t(keys.astype(np.int64)))
    tout, tn = migrate_mod.fold_segment(tstate, t(mn), t(mo), t(mmv), t(mpw),
                                        t(thr))
    assert tn == int(jn) and tn > 0
    for name in ("parent", "best"):
        for leaf in ("nodes", "outs"):
            assert np.array_equal(
                getattr(getattr(tout, name), leaf).numpy(),
                np.asarray(getattr(getattr(jout, name), leaf)))
    for name in ("parent_fit", "parent_metrics", "parent_power", "best_fit"):
        assert np.array_equal(getattr(tout, name).numpy(),
                              np.asarray(getattr(jout, name))), name


# ---------------------------------------------------------------------------
# pods under model_axis: each pod's rank at model coordinate 0 writes
# ---------------------------------------------------------------------------

MESH_CFG = dict(width=3, kind="mul", n_n=60)   # a 2-word cube: 2 slices


def _mesh_cfg():
    return SearchConfig(**MESH_CFG, evolve=EvolveConfig(generations=20,
                                                        lam=3))


def _pod_mesh_rank(rank, world, results_dir):
    from repro_torch.launch.mesh import make_sweep_mesh
    from repro_torch.parallel import ctx
    mesh = make_sweep_mesh(pods=2, device="cpu")
    with ctx.use_mesh(mesh):
        res = run_sweep_batched(
            _mesh_cfg(), [ConstraintSpec(**c) for c in CONSTRAINTS], SEEDS,
            SweepConfig(chunk_size=2, keep_history="summary", n_pods=2,
                        results_dir=results_dir, model_axis="model",
                        async_commit=rank % 2 == 0))
    return mesh.coords, res.completed


def test_pods_under_model_axis(tmp_path):
    from repro_torch.parallel.spawn import run_ranks
    want = tmp_path / "one"
    run_sweep_batched(_mesh_cfg(), [ConstraintSpec(**c) for c in CONSTRAINTS],
                      SEEDS, SweepConfig(chunk_size=2, keep_history="summary",
                                         results_dir=str(want)),
                      device="cpu")
    got = tmp_path / "mesh"
    ranks = run_ranks(_pod_mesh_rank, 4, str(got), timeout_s=240.0,
                      workdir=str(tmp_path))
    assert [c["pod"] for c, _ in ranks] == [0, 0, 1, 1]
    assert [c["model"] for c, _ in ranks] == [0, 1, 0, 1]
    # shards of both pods, the one-pod sweep's but for the sharded MRE sums
    # (reassociated over the slices; no constraint reads MRE here)
    _assert_dirs_match_prefix(got, want, ("shard_",))
    with open(got / "manifest.json") as f:
        assert json.load(f)["n_pods"] == 2
