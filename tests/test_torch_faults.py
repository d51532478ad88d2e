"""Crash consistency of the port's sweep (the reference's
``test_faults.py``, run on the port on the CPU).

Each test injects a fault at one point of the commit path -- a rename
that fails, a background commit that fails, a ``KeyboardInterrupt``
between chunks, a process killed mid-commit, a checkpoint that is never
committed, a migrant file lost after its epoch's shards -- and shows that
no partial shard appears under a committed name, that coverage never
names an uncommitted span, and that the resumed sweep gives the
uninterrupted one's bytes.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.core import sweep as sweep_mod
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.results import SweepResultReader
from repro_torch.core.search import SearchConfig
from repro_torch.core.sweep import SweepConfig, run_sweep_batched

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = SearchConfig(width=2, kind="add", n_n=40,
                   evolve=EvolveConfig(generations=40, lam=3))
CONSTRAINTS = [ConstraintSpec(mae=1.0), ConstraintSpec(mae=2.0),
               ConstraintSpec(er=50.0)]
SEEDS = (0, 1)
N_RUNS = len(CONSTRAINTS) * len(SEEDS)  # chunks of 2: three chunks


def _sweep(results_dir, **kw):
    return run_sweep_batched(CFG, CONSTRAINTS, SEEDS, SweepConfig(
        chunk_size=2, keep_history="summary", results_dir=str(results_dir),
        **kw), device="cpu")


def _shards(d):
    return sorted(f for f in os.listdir(d) if f.startswith("shard_")
                  and f.endswith(".npz") and ".tmp." not in f)


def _shard_bytes(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in _shards(d)}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The uninterrupted sweep every interrupted one must come back to."""
    d = tmp_path_factory.mktemp("reference")
    assert _sweep(d).completed == N_RUNS
    return str(d)


def _assert_resumes_to_reference(crash_dir, reference, **kw):
    res = _sweep(crash_dir, **kw)
    assert res.completed == N_RUNS
    a, b = _shard_bytes(reference), _shard_bytes(str(crash_dir))
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name] == b[name], f"shard bytes differ after resume: {name}"


def _failing_replace(monkeypatch, nth, exc=OSError("injected: disk gone")):
    """The ``nth`` shard commit's rename raises: the instant between a
    whole temp file and its atomic publication."""
    orig = os.replace
    seen = []

    def bomb(src, dst):
        if os.path.basename(dst).startswith("shard_"):
            seen.append(dst)
            if len(seen) == nth:
                raise exc
        return orig(src, dst)

    monkeypatch.setattr(os, "replace", bomb)
    return seen


@pytest.mark.parametrize("async_commit", [False, True])
def test_commit_failure_then_resume(tmp_path, monkeypatch, reference,
                                    async_commit):
    """A failed shard commit raises out of the sweep; in the background
    it poisons the queue, so the third chunk's commit is dropped rather
    than landing after the gap."""
    _failing_replace(monkeypatch, nth=2)
    with pytest.raises(OSError, match="injected"):
        _sweep(tmp_path, async_commit=async_commit, commit_depth=1)
    monkeypatch.undo()
    assert len(_shards(tmp_path)) == 1
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp.npz")]
    assert len(SweepResultReader(str(tmp_path)).spans()) == 1
    _assert_resumes_to_reference(tmp_path, reference,
                                 async_commit=async_commit)


def test_async_keyboard_interrupt_drains_then_resumes(tmp_path, monkeypatch,
                                                      reference):
    real = sweep_mod.characterize_chunk
    calls = []

    def interrupted(*args, **kw):
        calls.append(1)
        if len(calls) == 3:  # chunks 1-2 done, their commits maybe queued
            raise KeyboardInterrupt
        return real(*args, **kw)

    monkeypatch.setattr(sweep_mod, "characterize_chunk", interrupted)
    with pytest.raises(KeyboardInterrupt):
        _sweep(tmp_path, async_commit=True)
    monkeypatch.undo()
    # both finished chunks were committed on the way out
    assert len(_shards(tmp_path)) == 2
    ref = _shard_bytes(reference)
    for name, blob in _shard_bytes(str(tmp_path)).items():
        assert blob == ref[name]
    _assert_resumes_to_reference(tmp_path, reference, async_commit=True)


@pytest.mark.parametrize("async_commit", [False, True])
def test_hard_kill_mid_commit_subprocess(tmp_path, reference, async_commit):
    """``os._exit`` after a shard's temp file is written and before its
    rename: at most temp debris, never a committed name."""
    code = f"""
import os
orig = os.replace
seen = []
def bomb(src, dst):
    if os.path.basename(dst).startswith("shard_"):
        seen.append(dst)
        if len(seen) == 2:
            os._exit(3)  # power lost: the temp file written, never renamed
    return orig(src, dst)
os.replace = bomb
import torch
torch.set_num_threads(1)
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.search import SearchConfig
from repro_torch.core.sweep import SweepConfig, run_sweep_batched
cfg = SearchConfig(width=2, kind="add", n_n=40,
                   evolve=EvolveConfig(generations=40, lam=3))
cons = [ConstraintSpec(mae=1.0), ConstraintSpec(mae=2.0),
        ConstraintSpec(er=50.0)]
run_sweep_batched(cfg, cons, (0, 1), SweepConfig(
    chunk_size=2, keep_history="summary", results_dir={str(tmp_path)!r},
    async_commit={async_commit}), device="cpu")
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", code],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 3, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    assert len(_shards(tmp_path)) == 1
    assert len(SweepResultReader(str(tmp_path)).spans()) == 1
    _assert_resumes_to_reference(tmp_path, reference)


@pytest.mark.parametrize("async_commit", [False, True])
def test_checkpoint_commit_crash_then_resume(tmp_path, monkeypatch,
                                             async_commit):
    ck = str(tmp_path / "ck")
    sweep = dict(chunk_size=2, async_commit=async_commit)
    want = run_sweep_batched(CFG, CONSTRAINTS, SEEDS, SweepConfig(
        checkpoint_dir=str(tmp_path / "ref"), **sweep), device="cpu")
    orig = os.rename
    seen = []

    def bomb(src, dst):
        if os.path.basename(dst).startswith("step_"):
            seen.append(dst)
            if len(seen) == 2:
                raise OSError("injected: checkpoint rename lost")
        return orig(src, dst)

    monkeypatch.setattr(os, "rename", bomb)
    with pytest.raises(OSError, match="injected"):
        run_sweep_batched(CFG, CONSTRAINTS, SEEDS, SweepConfig(
            checkpoint_dir=ck, **sweep), device="cpu")
    monkeypatch.undo()
    assert len(store.committed_steps(ck)) == 1  # step 2 never visible
    res = run_sweep_batched(CFG, CONSTRAINTS, SEEDS, SweepConfig(
        checkpoint_dir=ck, **sweep), device="cpu")
    assert res.completed == N_RUNS
    for key in ("metrics", "power_rel", "best_fit"):
        np.testing.assert_array_equal(getattr(res, key), getattr(want, key))


@pytest.mark.parametrize("victim", [0, -1])
def test_lost_migrant_publish_republished_identically(tmp_path, victim):
    """A migrant file lost after its epoch's shards were committed (a stop
    between the last shard commit and the publish): the resumed pod, with
    nothing left to run, publishes the same bytes again."""
    res = _sweep(tmp_path, migrate_every=1)
    assert res.completed == N_RUNS
    migrants = sorted(f for f in os.listdir(tmp_path)
                      if f.startswith("migrants_"))
    assert len(migrants) == 3
    path = os.path.join(str(tmp_path), migrants[victim])
    want = open(path, "rb").read()
    os.remove(path)
    res = _sweep(tmp_path, migrate_every=1)
    assert res.completed == N_RUNS and res.runs_per_sec == 0.0
    assert res.migrate_stats["published"] == 1
    assert open(path, "rb").read() == want
