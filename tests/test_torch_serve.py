"""Serving on the CPU against the JAX package, on the same weights.

``_serve_loop`` (continuous batching over 4 slots, greedy decoding) gives
the JAX package's tokens in float32 and on an approximate multiplier.  The
untrained model's logits lie close together, and on the approximate
multiplier an activation on a rounding boundary may quantize one step
apart in the two packages; a slot batch may then split.  A split is
allowed only where it is a tie: replaying the batch in lockstep, the first
step whose greedy tokens differ must have, in both packages, the two
candidates' logits within TIE_ATOL of each other, and the two packages'
logits within TIE_ATOL everywhere.  ``quality_report``'s perplexities agree
within rtol 1e-4, and the CLI serves a width-8 registry artifact.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_2_1b as JL
from repro.launch import serve as j_serve
from repro.models import model as JM
from repro.models import quant as JQ
from repro_torch import convert
from repro_torch.configs import llama3_2_1b as TL
from repro_torch.core.artifacts import export_elites, verify_registry
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.search import SearchConfig
from repro_torch.core.sweep import SweepConfig, run_sweep_batched
from repro_torch.launch import serve as t_serve
from repro_torch.models import model as TM
from repro_torch.models import quant as TQ

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_REQ, PROMPT, GEN, SLOTS = 8, 32, 16, 4
# a one-step q flip moved the reduced model's logits by up to 0.022; the
# untrained model's top-2 gaps are often smaller than that
TIE_ATOL = 0.05


def _lut():
    rng = np.random.default_rng(1)
    exact = np.arange(256)[:, None] * np.arange(256)[None, :]
    return np.clip(exact + rng.integers(-40, 41, exact.shape),
                   0, 65535).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JL.reduced(), TL.reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.model_params(jp, tcfg)


@pytest.fixture(autouse=True)
def _no_lut():
    JQ.set_multiplier_lut(None)
    TQ.set_multiplier_lut(None)
    yield
    JQ.set_multiplier_lut(None)
    TQ.set_multiplier_lut(None)


def _first_split(jcfg, tcfg, jp, tp, prompts):
    """Replay one slot batch in lockstep (both fed the JAX tokens) up to
    the first step whose greedy tokens differ: (step, rows, JAX logits,
    port logits), or None.  Step -1 is the prefill."""
    jl, jc = JM.prefill(jp, jnp.asarray(prompts), jcfg,
                        max_len=PROMPT + GEN)
    with torch.inference_mode():
        tl, tc = TM.prefill(tp, torch.as_tensor(prompts, dtype=torch.int64),
                            tcfg, max_len=PROMPT + GEN)
        for step in range(-1, GEN):
            a = np.asarray(jl[:, -1], np.float32)
            b = tl[:, -1].to(torch.float32).numpy()
            rows = np.flatnonzero(a.argmax(-1) != b.argmax(-1))
            if rows.size:
                return step, rows, a, b
            if step == GEN - 1:
                return None
            tok = a.argmax(-1).astype(np.int32)[:, None]
            pos = np.full((SLOTS,), PROMPT + step + 1, np.int32)
            jl, jc = JM.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos), jcfg)
            tl, tc = TM.decode_step(tp, tc, torch.as_tensor(tok).long(),
                                    torch.as_tensor(pos).long(), tcfg)


def _assert_same_or_tie(jcfg, tcfg, jp, tp, want, got):
    """Per slot batch: identical tokens, or a first split at a tie."""
    prompts_rng = np.random.default_rng(0)
    prompts = [prompts_rng.integers(0, jcfg.vocab, (PROMPT,), dtype=np.int32)
               for _ in range(N_REQ)]
    splits = []
    for b in range(N_REQ // SLOTS):
        rids = range(b * SLOTS, (b + 1) * SLOTS)
        diff = [r for r in rids if want[r] != got[r]]
        if not diff:
            continue
        step, rows, a, t = _first_split(jcfg, tcfg, jp, tp,
                                        np.stack([prompts[r] for r in rids]))
        # the outputs agree up to the replayed split (a prefill split shows
        # at output step 0, a decode split at its own step)
        first_out = min(next(i for i, (x, y) in enumerate(
            zip(want[r], got[r])) if x != y) for r in diff)
        assert first_out == max(step, 0)
        assert np.abs(a - t).max() <= TIE_ATOL
        for i in rows:
            ja, ta = a[i].argmax(), t[i].argmax()
            assert a[i, ja] - a[i, ta] <= TIE_ATOL
            assert t[i, ta] - t[i, ja] <= TIE_ATOL
        splits.append((b, step))
    return splits


def test_serve_fp32_tokens_match_jax(models):
    jcfg, tcfg, jp, tp = models
    want = j_serve._serve_loop(jcfg, N_REQ, PROMPT, GEN, SLOTS, 0)
    got = t_serve._serve_loop(tcfg, tp, N_REQ, PROMPT, GEN, SLOTS, 0, "cpu")
    assert got["decoded_tokens"] == want["decoded_tokens"] == N_REQ * GEN
    assert got["requests"] == N_REQ and got["tok_per_s"] > 0
    assert _assert_same_or_tie(jcfg, tcfg, jp, tp, want["outputs"],
                               got["outputs"]) == []


def test_serve_pallas_tokens_match_jax(models):
    """``attn_impl="pallas"``: JAX's flash kernel (interpret mode) in its
    prefills against the port's ``ops.flash_attention`` (the plain version
    on the CPU); decode keeps the local cache in both."""
    jcfg, tcfg, jp, tp = models
    jcfg = dataclasses.replace(jcfg, attn_impl="pallas")
    tcfg = dataclasses.replace(tcfg, attn_impl="pallas")
    want = j_serve._serve_loop(jcfg, N_REQ, PROMPT, GEN, SLOTS, 0)
    got = t_serve._serve_loop(tcfg, tp, N_REQ, PROMPT, GEN, SLOTS, 0, "cpu")
    assert got["decoded_tokens"] == want["decoded_tokens"] == N_REQ * GEN
    assert _assert_same_or_tie(jcfg, tcfg, jp, tp, want["outputs"],
                               got["outputs"]) == []


def test_serve_approx_tokens_match_jax_or_tie(models):
    jcfg, tcfg, jp, tp = models
    lut = _lut()
    JQ.set_multiplier_lut(lut)
    TQ.set_multiplier_lut(lut)
    jcfg = dataclasses.replace(jcfg, approx_matmul=True)
    tcfg = dataclasses.replace(tcfg, approx_matmul=True)
    want = j_serve._serve_loop(jcfg, N_REQ, PROMPT, GEN, SLOTS, 0)
    got = t_serve._serve_loop(tcfg, tp, N_REQ, PROMPT, GEN, SLOTS, 0, "cpu")
    splits = _assert_same_or_tie(jcfg, tcfg, jp, tp, want["outputs"],
                                 got["outputs"])
    # the first slot batch runs the same tokens; a split stays the
    # exception it is argued to be
    assert all(b > 0 for b, _ in splits) and len(splits) <= 1, splits


def test_quality_report_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    lut = _lut()
    want = j_serve.quality_report("llama3_2_1b", lut, seq_len=PROMPT)
    toks = jax.random.randint(jax.random.PRNGKey(0), (4, PROMPT), 0,
                              jcfg.vocab)
    got = t_serve.quality_report(
        "llama3_2_1b", lut, device="cpu", params=tp,
        tokens=torch.as_tensor(np.array(toks), dtype=torch.int64))
    assert set(got) == set(want)
    for k in ("ppl_fp32", "ppl_int8", "ppl_approx"):
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    for k in ("logit_mae_vs_fp32", "logit_mae_vs_int8"):
        assert got[k] == pytest.approx(want[k], rel=1e-3), k
    assert TQ._LUT is None            # the previous (no) table is restored


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    """A width-8 registry: a few generations of the 8×8 multiplier on the
    port's CPU path, exported."""
    shards = str(tmp_path_factory.mktemp("w8-shards"))
    out = str(tmp_path_factory.mktemp("w8-registry"))
    run_sweep_batched(
        SearchConfig(width=8, kind="mul", n_n=400,
                     evolve=EvolveConfig(generations=4, lam=2,
                                         mutation_rate=0.02)),
        [ConstraintSpec(er=99.0)], (0,),
        SweepConfig(chunk_size=1, keep_history="summary",
                    results_dir=shards),
        device="cpu")
    export_elites(shards, out)
    (art,) = verify_registry(out)
    assert art.lut.shape == (256, 256) and int(art.lut.max()) < 1 << 16
    return out


def test_cli_serves_a_registry_on_the_cpu(registry, tmp_path, capsys):
    summary = str(tmp_path / "deploy_summary.json")
    t_serve.main(["--arch", "llama3_2_1b", "--reduced", "--device", "cpu",
                  "--requests", "3", "--gen-len", "4", "--slots", "2",
                  "--approx-lut", registry, "--summary-out", summary])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] approx artifact ")
    assert lines[1].startswith("[serve] 3 requests, 12 tokens, ")
    assert lines[2].startswith("[serve] perplexity fp32 ")
    assert lines[3].startswith("[serve] logit MAE vs int8 ")
    assert lines[4] == f"[serve] wrote {summary}"
    with open(summary) as f:
        s = json.load(f)
    assert s["device"] == "cpu" and s["serve"]["decoded_tokens"] == 12
    assert len(s["artifact"]["digest"]) == 64
    for k in ("ppl_fp32", "ppl_int8", "ppl_approx"):
        assert math.isfinite(s["quality"][k])


def test_serve_rejects_a_wrong_table():
    with pytest.raises(ValueError, match="256x256"):
        t_serve.serve("llama3_2_1b", approx_lut=np.zeros((16, 16), np.int32),
                      device="cpu")


def test_cli_help_without_gpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               CUDA_VISIBLE_DEVICES="")
    for mod, flags in (("repro_torch.launch.serve",
                        ("--arch", "--approx-lut", "--summary-out",
                         "--device", "--reduced", "--slots")),
                       ("repro_torch.launch.export",
                        ("--results-dir", "--out", "--top-k",
                         "--require-certified", "--verify"))):
        out = subprocess.run([sys.executable, "-m", mod, "--help"],
                             capture_output=True, text=True, cwd=REPO,
                             timeout=120, env=env)
        assert out.returncode == 0, out.stderr
        for flag in flags:
            assert flag in out.stdout


def _example(name):
    import runpy
    return runpy.run_path(os.path.join(REPO, "examples", name),
                          run_name="example")


def test_approx_nn_example_matches_reference(registry, capsys, monkeypatch):
    """``examples/approx_nn_inference_torch.py`` on a registry against the
    reference's example on the same weights and tokens: the same artifact
    line and LUT error, the three perplexities within rel 1e-4 (as the
    quality report)."""
    from repro.configs.base import ModelConfig as JModelConfig
    j_main = _example("approx_nn_inference.py")["main"]
    t_mod = _example("approx_nn_inference_torch.py")
    want = j_main(["--registry", registry, "--batch", "2", "--seq-len",
                   "32"])
    want_out = capsys.readouterr().out
    jcfg = JModelConfig(name="toy", n_layers=2, d_model=64, n_heads=4,
                        n_kv_heads=2, d_ff=128, vocab=256)
    params = convert.model_params(JM.init_params(jax.random.PRNGKey(0),
                                                 jcfg), t_mod["CONFIG"])
    got = t_mod["main"](["--registry", registry, "--batch", "2",
                         "--seq-len", "32", "--device", "cpu"],
                        params=params)
    got_out = capsys.readouterr().out
    assert got_out.splitlines()[:2] == want_out.splitlines()[:2]
    for k in ("ppl_fp32", "ppl_int8", "ppl_approx"):
        assert math.isfinite(got[k])
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    assert (got["power_rel"], got["constraint"]) == (want["power_rel"],
                                                     want["constraint"])
    assert TQ._LUT is None
    # the port's own seeded weights: three finite perplexities
    own = t_mod["main"](["--registry", registry, "--batch", "2",
                         "--seq-len", "16", "--device", "cpu"])
    assert all(math.isfinite(own[k]) for k in ("ppl_fp32", "ppl_int8",
                                               "ppl_approx"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_mod["main"](["--registry", registry])
