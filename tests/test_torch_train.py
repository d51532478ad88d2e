"""Training on the port against the JAX package: microbatching, a loss
curve, checkpoints and resume across the packages, and the training
substrate (data loader, document packing, async checkpoints, fault
runtime).  The port starts from the reference's initial parameters
(``convert.model_params``) and the same ``synth_batch`` batches.

Tolerances (measured on the reduced configs on the CPU):

* loss: LOSS_RTOL (the two packages' float32 sums differ by <= 2.3e-7
  relative); a 15-step curve within CURVE_ATOL (<= 3.4e-6 seen);
* gradients: each leaf within GRAD_RTOL of its largest |g| (<= 1.4e-6
  seen);
* parameters after a step: within PARAM_RTOL of |p|, or split at a proven
  tie (``tests/test_torch_configs.py``, which holds one train step of each
  dense configuration against the reference).
"""
import dataclasses
import os
import runpy
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # bare image: deterministic property-test fallback
    from _hypothesis_fallback import given, settings, st

from repro.checkpoint import store as j_store
from repro.configs import base as JB
from repro.data import pipeline as JP
from repro.launch import steps as JST
from repro.launch import train as j_train
from repro.models import model as JM
from repro.optim import OptConfig as JOptConfig
from repro.optim import init_opt_state as j_init_opt_state
from repro_torch import convert as C
from repro_torch import tree as T
from repro_torch.checkpoint import store
from repro_torch.configs import base as TB
from repro_torch.data.pipeline import (DataConfig, PrefetchLoader,
                                       pack_documents, synth_batch)
from repro_torch.launch import steps as ST
from repro_torch.launch import train as t_train
from repro_torch.models import model as TM
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.runtime.fault import (HeartbeatMonitor, StragglerDetector,
                                       TrainGuard, retry)

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-6
CURVE_ATOL = 2e-5
GRAD_RTOL = 1e-5
PARAM_RTOL = 5e-7


def _models(arch, seed=0):
    jcfg = JB.get_arch(arch).reduced()
    tcfg = TB.get_arch(arch).reduced()
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp


def _batch(cfg, step=0, B=8, S=64):
    b = synth_batch(DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B),
                    step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v, dtype=torch.int64) for k, v in b.items()})


def _leaves(tree):
    return [np.asarray(x) if not isinstance(x, torch.Tensor)
            else C.to_host(x) for x in T.leaves(tree)]


def _check_grads(jg, tg):
    noise = []
    for a, b in zip(_leaves(jg), _leaves(tg)):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=GRAD_RTOL * np.abs(a).max())
        noise.append(np.abs(a - b).max())
    return noise


@pytest.mark.parametrize("port_mb", [1, 2])
def test_microbatches_match_single_and_reference(port_mb):
    """Two microbatches against one (the reference's
    ``test_microbatched_train_step_matches_single``), and the port's
    two-microbatch step against the reference's."""
    cfg_kw = dict(n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                  vocab=128)
    jcfg, tcfg = JB.ModelConfig(**cfg_kw), TB.ModelConfig(**cfg_kw)
    key = jax.random.PRNGKey(0)
    jp = JM.init_params(key, jcfg)
    toks = np.array(jax.random.randint(key, (8, 16), 0, 128))
    tb = {"tokens": torch.as_tensor(toks, dtype=torch.int64),
          "targets": torch.as_tensor(np.roll(toks, 1, 1),
                                     dtype=torch.int64)}
    to = OptConfig(weight_decay=0.0)
    step = lambda mb: ST.make_train_step(tcfg, to, microbatches=mb)
    p1 = C.model_params(jp, tcfg)
    _, _, m1 = step(1)(p1, init_opt_state(C.reference_tree(p1, tcfg), to),
                       tb, 0)
    p2 = C.model_params(jp, tcfg)
    _, _, m2 = step(port_mb * 2)(
        p2, init_opt_state(C.reference_tree(p2, tcfg), to), tb, 0)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    for a, b in zip(_leaves(C.reference_params(p1, tcfg)),
                    _leaves(C.reference_params(p2, tcfg))):
        np.testing.assert_allclose(b, a, rtol=2e-3, atol=2e-4)
    jo = JOptConfig(weight_decay=0.0)
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    jp2, _, jm = jax.jit(JST.make_train_step(
        jcfg, jo, microbatches=port_mb * 2))(jp, j_init_opt_state(jp, jo),
                                              jb, jnp.int32(0))
    assert float(m2["loss"]) == pytest.approx(float(jm["loss"]),
                                              rel=LOSS_RTOL)
    for a, b in zip(_leaves(jp2), _leaves(C.reference_params(p2, tcfg))):
        np.testing.assert_allclose(b, a, rtol=PARAM_RTOL,
                                   atol=2.2 * to.lr / to.warmup_steps)


def _port_train(arch, jp, tcfg, **kw):
    return t_train.train(arch, reduced=True, device="cpu", log_every=100,
                         params=C.model_params(jp, tcfg), **kw)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "stablelm_12b"])
def test_loss_curve_matches_reference(arch, capsys):
    """Ten steps of ``train(..., reduced=True)`` from the same initial
    parameters: the same loss curve within CURVE_ATOL, the same log
    lines."""
    jcfg, tcfg, jp = _models(arch)
    want = j_train.train(arch, steps=10, reduced=True, log_every=3)
    jout = capsys.readouterr().out
    got = t_train.train(arch, steps=10, reduced=True, device="cpu",
                        log_every=3, params=C.model_params(jp, tcfg))
    tout = capsys.readouterr().out
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=CURVE_ATOL)
    strip = lambda out: [l.rsplit(" (", 1)[0] for l in out.splitlines()]
    assert len(strip(tout)) == len(strip(jout)) == 4
    assert [l[:len("[train] step 9")] for l in strip(tout)] == [
        l[:len("[train] step 9")] for l in strip(jout)]
    assert len(got["step_s"]) == len(got["data_s"]) == 10


def _step_files(d, step):
    sd = os.path.join(d, f"step_{step:08d}")
    return sd, sorted(f for f in os.listdir(sd) if f.startswith("leaf_"))


@pytest.fixture(scope="module")
def full_run():
    """The reference's uninterrupted 15-step run."""
    return j_train.train("llama3_2_1b", steps=15, reduced=True,
                         log_every=100)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_packages(first, full_run, tmp_path, capsys):
    """One package trains 10 steps with a checkpoint every 5, the other
    resumes to 15: the losses of steps 10-14 match the reference's
    uninterrupted run, and the first package's step-10 checkpoint, loaded
    and saved again by the second, is the same bytes."""
    arch = "llama3_2_1b"
    jcfg, tcfg, jp = _models(arch)
    d = str(tmp_path / "ck")
    if first == "jax":
        j_train.train(arch, steps=10, reduced=True, ckpt_dir=d,
                      ckpt_every=5, log_every=100)
        out = _port_train(arch, jp, tcfg, steps=15, ckpt_dir=d,
                          ckpt_every=5)
    else:
        _port_train(arch, jp, tcfg, steps=10, ckpt_dir=d, ckpt_every=5)
        out = j_train.train(arch, steps=15, reduced=True, ckpt_dir=d,
                            ckpt_every=5, log_every=100)
    assert "[train] resumed from step 10" in capsys.readouterr().out
    np.testing.assert_allclose(out["losses"], full_run["losses"][10:],
                               rtol=0, atol=CURVE_ATOL)
    assert store.committed_steps(d) == j_store.committed_steps(d) == [
        5, 10, 15]

    again = str(tmp_path / "again")     # step 10 through the other package
    if first == "jax":
        params = TM.init_params(torch.Generator().manual_seed(1), tcfg)
        tmpl = {"params": C.reference_tree(params, tcfg),
                "opt": init_opt_state(C.reference_tree(params, tcfg),
                                      OptConfig())}
        tree, meta = store.load_checkpoint(d, 10, tmpl)
        store.save_checkpoint(again, 10, tree, meta)
    else:
        jtmpl = {"params": jp, "opt": j_init_opt_state(jp, JOptConfig())}
        tree, meta = j_store.load_checkpoint(d, 10, jtmpl)
        j_store.save_checkpoint(again, 10, tree, meta)
    sd, files = _step_files(d, 10)
    sd2, files2 = _step_files(again, 10)
    assert files == files2 and len(files) == 3 * len(T.leaves(jp))
    for f in files:
        with open(os.path.join(sd, f), "rb") as a, \
                open(os.path.join(sd2, f), "rb") as b:
            assert a.read() == b.read(), f


def test_checkpoint_leaves_are_the_references(tmp_path):
    """The same float32 state saved by both packages is the same files,
    leaf for leaf; bfloat16 leaves are written as the reference writes
    them (``'<V2'``) and read back exactly by both."""
    jcfg, tcfg, jp = _models("stablelm_1_6b")
    jo = JOptConfig(name="adamw8bit")
    js = j_init_opt_state(jp, jo)
    tp = C.model_params(jp, tcfg)
    ts = C.opt_state(js)
    j_store.save_checkpoint(str(tmp_path / "j"), 3, {"params": jp,
                                                     "opt": js})
    store.save_checkpoint(str(tmp_path / "t"), 3,
                          {"params": C.reference_tree(tp, tcfg), "opt": ts})
    sd, files = _step_files(str(tmp_path / "j"), 3)
    sd2, files2 = _step_files(str(tmp_path / "t"), 3)
    assert files == files2
    for f in files:
        with open(os.path.join(sd, f), "rb") as a, \
                open(os.path.join(sd2, f), "rb") as b:
            assert a.read() == b.read(), f
    # bfloat16: a leaf of the reference's dtype, written by both
    bf = jnp.asarray(np.random.default_rng(0).standard_normal((5, 7)),
                     jnp.bfloat16)
    j_store.save_checkpoint(str(tmp_path / "jb"), 1, {"w": bf})
    tw = C.to_tensor(np.asarray(bf), torch.bfloat16)
    store.save_checkpoint(str(tmp_path / "tb"), 1, {"w": tw})
    for name in ("leaf_0.npy",):
        with open(os.path.join(tmp_path, "jb", "step_00000001", name),
                  "rb") as a, open(os.path.join(tmp_path, "tb",
                                                "step_00000001", name),
                                   "rb") as b:
            assert a.read() == b.read()
    got, _ = store.load_checkpoint(str(tmp_path / "jb"), 1,
                                   {"w": torch.zeros((5, 7),
                                                     dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], tw)
    num, _ = store.load_checkpoint(str(tmp_path / "tb"), 1,
                                   {"w": np.zeros((5, 7), np.float32)})
    assert np.array_equal(num["w"], np.asarray(bf, np.float32))


def test_bf16_params_round_trip(tmp_path):
    """A bfloat16 model's parameters through ``reference_params`` (2-byte
    records), a checkpoint and ``model_params``: bit for bit."""
    cfg = dataclasses.replace(TB.get_arch("stablelm_1_6b").reduced(),
                              param_dtype="bfloat16")
    p = TM.init_params(torch.Generator().manual_seed(0), cfg)
    ref = C.reference_params(p, cfg)
    assert ref["lm_head"].dtype == np.dtype("V2")
    store.save_checkpoint(str(tmp_path), 1, {"params": ref})
    tree, _ = store.load_checkpoint(str(tmp_path), 1, {"params": ref})
    q = C.model_params(tree["params"], cfg)
    for (n, a), (_, b) in zip(p.named_parameters(), q.named_parameters()):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), n


def test_remat_and_chunked_loss_keep_the_gradients():
    """``remat`` (both policies) and the checkpointed chunked loss change
    what the backward pass keeps, not its result."""
    base = dataclasses.replace(TB.get_arch("llama3_2_1b").reduced(),
                               loss_vocab_chunk=16)
    jcfg, _, jp = _models("llama3_2_1b")
    _, tb = _batch(base, B=4, S=48)
    out = {}
    for name, cfg in (("plain", base),
                      ("all", dataclasses.replace(base, remat=True)),
                      ("blocks", dataclasses.replace(
                          base, remat=True, remat_policy="block_outputs")),
                      ("unchunked", dataclasses.replace(
                          base, loss_vocab_chunk=0))):
        out[name] = ST.loss_and_grads(C.model_params(jp, cfg), cfg,
                                      tb["tokens"], tb["targets"])
    for name in ("all", "blocks"):
        assert torch.equal(out[name][0], out["plain"][0])
        for a, b in zip(T.leaves(out["plain"][1]), T.leaves(out[name][1])):
            assert torch.equal(a, b), name
    assert float(out["unchunked"][0]) == pytest.approx(
        float(out["plain"][0]), rel=LOSS_RTOL)
    _check_grads(out["unchunked"][1], out["plain"][1])
    with pytest.raises(ValueError, match="remat_policy"):
        bad = dataclasses.replace(base, remat=True, remat_policy="some")
        ST.loss_and_grads(C.model_params(jp, bad), bad, tb["tokens"],
                          tb["targets"])


def test_serving_builds_no_graph_after_training():
    """After a training step in the same process, the trained parameters
    serve without an autograd graph, and freshly made ones carry no
    gradient flag."""
    from repro_torch.launch import serve as t_serve
    cfg = TB.get_arch("llama3_2_1b").reduced()
    out = t_train.train("llama3_2_1b", steps=1, reduced=True, device="cpu")
    params = out["params"]
    assert all(p.requires_grad for p in params.parameters())
    assert all(p.grad is None for p in params.parameters())
    toks = torch.zeros((2, 8), dtype=torch.int64)
    logits, cache = TM.prefill(params, toks, cfg, max_len=12)
    assert logits.grad_fn is None and not logits.requires_grad
    assert all(c["k"].grad_fn is None for c in cache)
    logits, _ = TM.decode_step(params, cache, toks[:, :1],
                               torch.full((2,), 8), cfg)
    assert logits.grad_fn is None and not logits.requires_grad
    res = t_serve.serve("llama3_2_1b", n_requests=2, prompt_len=8,
                        gen_len=2, slots=2, device="cpu", params=params)
    assert res["decoded_tokens"] == 4
    fresh = TM.init_params(torch.Generator().manual_seed(0), cfg)
    assert not any(p.requires_grad for p in fresh.parameters())


def test_prefill_and_decode_steps():
    """The step builders call the model's prefill and decode."""
    cfg = TB.get_arch("phi4_mini_3_8b").reduced()
    params = TM.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    logits, cache = ST.make_prefill_step(cfg)(params, {"tokens": toks})
    want, _ = TM.prefill(params, toks, cfg)
    assert torch.equal(logits, want) and len(cache) == cfg.n_layers
    pos = torch.full((2,), 7)
    got, _ = ST.make_decode_step(cfg)(params, cache, {"tokens": toks[:, -1:],
                                                      "pos": pos})
    assert got.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(got).all())


def test_train_guards(monkeypatch):
    # every reference mesh is ported (--mesh host trains:
    # tests/test_torch_parallel_lm.py); a production mesh on a world of
    # another size raises as jax.make_mesh does, an unknown name raises
    with pytest.raises(ValueError, match="needs 256 ranks, the world has 1"):
        t_train.train("llama3_2_1b", steps=1, device="cpu",
                      mesh_name="single")
    with pytest.raises(ValueError, match="ring"):
        t_train.train("llama3_2_1b", steps=1, device="cpu",
                      mesh_name="ring")
    cfg = dataclasses.replace(TB.get_arch("llama3_2_1b").reduced(),
                              attn_impl="pallas")
    with pytest.raises(NotImplementedError, match="pallas"):
        t_train.train("llama3_2_1b", steps=1, device="cpu", config=cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.train("llama3_2_1b", steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(["--arch", "llama3_2_1b", "--reduced", "--steps", "1"])


def test_cli_loss_decreases(capsys):
    t_train.main(["--arch", "llama3_2_1b", "--reduced", "--steps", "30",
                  "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    losses = [float(l.split()[4]) for l in lines
              if l.startswith("[train] step ")]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert lines[-1].startswith("[train] done: final loss ")


def test_train_lm_example_tiny(tmp_path, capsys):
    main = runpy.run_path(os.path.join(REPO, "examples",
                                       "train_lm_torch.py"),
                          run_name="example")["main"]
    args = ["--tiny", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    out = main(args)
    text = capsys.readouterr().out
    assert "training loss decreased — OK" in text
    assert out["losses"][-1] < out["losses"][0]
    assert store.latest_step(str(tmp_path)) == 30
    again = main(args)                  # resumes at the end: nothing to do
    assert again["losses"] == [] and "resumed from step 30" in \
        capsys.readouterr().out


# ------------------------------ substrate -----------------------------------

def test_synth_batch_matches_reference():
    for cfg in (DataConfig(vocab=1000, seq_len=16, global_batch=4, seed=7),
                DataConfig(vocab=128, seq_len=8, global_batch=3,
                           n_codebooks=4)):
        jcfg = JP.DataConfig(**dataclasses.asdict(cfg))
        for step in (0, 3):
            a, b = synth_batch(cfg, step), JP.synth_batch(jcfg, step)
            assert all(np.array_equal(a[k], b[k]) for k in b)


def test_prefetch_loader():
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=2)
    loader = PrefetchLoader(cfg, start_step=3)
    b0, b1 = next(loader), next(loader)
    loader.close()
    assert (b0["tokens"] == synth_batch(cfg, 3)["tokens"]).all()
    assert (b1["tokens"] == synth_batch(cfg, 4)["tokens"]).all()


def test_prefetch_loader_stops_after_close():
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=2)
    loader = PrefetchLoader(cfg, start_step=0)
    first = next(loader)
    assert (first["tokens"] == synth_batch(cfg, 0)["tokens"]).all()
    loader.close()
    t0 = time.monotonic()
    drained = list(loader)
    assert time.monotonic() - t0 < 5.0
    assert len(drained) <= 2
    with pytest.raises(StopIteration):
        next(loader)


def test_prefetch_loader_close_while_blocked():
    """A ``close()`` issued while ``__next__`` waits on an empty queue is
    seen: the waiting call raises StopIteration."""
    import threading
    cfg = DataConfig(vocab=64, seq_len=8, global_batch=2)
    loader = PrefetchLoader(cfg, start_step=0, depth=1)
    loader.close()
    while True:                 # drain, so the next call blocks
        try:
            loader._q.get_nowait()
        except Exception:
            break
    loader._stop.clear()        # a consumer blocked on an open loader ...
    result = []
    t = threading.Thread(target=lambda: result.append(
        next(loader, "stopped")))
    t.start()
    time.sleep(0.3)
    loader._stop.set()          # ... sees a close() issued meanwhile
    t.join(timeout=5)
    assert not t.is_alive() and result == ["stopped"]


@given(st.lists(st.lists(st.integers(0, 250), min_size=0, max_size=40),
                min_size=1, max_size=10),
       st.integers(4, 32))
@settings(max_examples=10, deadline=None)
def test_pack_documents_matches_reference(docs, seq_len):
    out = pack_documents(docs, seq_len, 255)
    assert np.array_equal(out, JP.pack_documents(docs, seq_len, 255))
    flat = [t for d in docs for t in d + [255]]
    assert (out.reshape(-1)[:len(flat)] == np.asarray(flat, np.int32)).all()
    assert out.shape[1] == seq_len and out.dtype == np.int32


def test_async_checkpointer_and_cleanup(tmp_path):
    ck = store.AsyncCheckpointer()
    w = torch.ones((4,))
    for s in (1, 2, 3, 4):
        ck.save(str(tmp_path), s, {"a": w, "b": {"c": w * s}})
        w.add_(1.0)             # the saved copy is taken before save returns
    ck.wait()
    store.cleanup(str(tmp_path), keep=2)
    assert store.committed_steps(str(tmp_path)) == [3, 4]
    tree, _ = store.load_checkpoint(str(tmp_path), 4,
                                    {"a": np.zeros(4, np.float32),
                                     "b": {"c": np.zeros(4, np.float32)}})
    assert np.array_equal(tree["a"], np.full(4, 4.0, np.float32))
    assert np.array_equal(tree["b"]["c"], np.full(4, 16.0, np.float32))
    bad = store.AsyncCheckpointer()
    (tmp_path / "file").write_text("x")
    bad.save(str(tmp_path / "file"), 1, {"a": w})   # not a directory
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                  # the error is raised once


def test_heartbeat_deadline():
    t = {"now": 0.0}
    mon = HeartbeatMonitor(deadline_s=10.0, clock=lambda: t["now"])
    mon.beat("h0")
    mon.beat("h1")
    t["now"] = 5.0
    assert mon.dead_hosts() == []
    t["now"] = 11.0
    mon.beat("h1")
    assert mon.dead_hosts() == ["h0"]
    assert mon.alive("h1") and not mon.alive("h0")


def test_straggler_detection():
    det = StragglerDetector(alpha=1.0, threshold=1.5, patience=2)
    flagged = []
    for _ in range(5):
        det.observe("fast0", 1.0)
        det.observe("fast1", 1.1)
        flagged = det.observe("slow", 3.0)
    assert flagged == ["slow"]


def test_retry_transient():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return 42

    slept = []
    assert retry(flaky, retries=5, sleep=slept.append) == 42
    assert calls["n"] == 3 and slept == [0.1, 0.2]
    with pytest.raises(OSError):
        retry(lambda: (_ for _ in ()).throw(OSError("x")).__next__(),
              retries=1, sleep=lambda s: None)


def test_train_guard_integration():
    t = {"now": 0.0}
    failures = []
    guard = TrainGuard(
        HeartbeatMonitor(deadline_s=5.0, clock=lambda: t["now"]),
        StragglerDetector(alpha=1.0, threshold=1.5, patience=1),
        on_failure=failures.append)
    guard.step("h0", 1.0)
    status = guard.step("h1", 1.0)
    assert status["dead"] == [] and status["stragglers"] == []
    t["now"] = 10.0
    status = guard.step("h0", 1.0)
    assert status["dead"] == ["h1"]
    assert failures == [["h1"]]
