"""The port's configurations against the JAX package's: the dense
``llama3_2_1b``, ``phi4_mini_3_8b``, ``stablelm_1_6b`` and ``stablelm_12b``
(both stablelms with an untied ``lm_head``), the MoE ``qwen3_moe_30b_a3b``
and ``kimi_k2_1t_a32b``, the SSM ``mamba2_1_3b``, the hybrid
``jamba_1_5_large_398b``, and the front ends' ``llama3_2_vision_11b``
(gated cross-attention to image embeddings) and ``musicgen_large`` (GELU,
four codebooks).  The vision model runs with every cross layer's gate at
GATE and random image embeddings given to both packages (the reference's
zero gate and zero embeddings make a cross layer the identity).  Each
reduced configuration's forward on the
reference's weights (``convert.model_params``) gives the reference's
logits and aux loss within the float32 tolerance of ``test_torch_model``,
its prefill and decode the reference's logits and caches (carried across
by ``convert.cache``), its greedy serve loop the reference's tokens, its
``quality_report`` the reference's perplexities, and one train step with
its ``OPTIMIZER`` the reference's loss, gradients, parameters and state.
Each full-size configuration's parameter count, on the ``meta`` device,
is the reference's (``jax.eval_shape``), in ``tests/test_archs.py``'s
ranges.

Train-step tolerances (measured on the reduced configs on the CPU): the
loss within LOSS_RTOL (<= 2.3e-7 relative seen); each gradient leaf within
GRAD_RTOL of its largest |g| (<= 1.4e-6 seen); the parameters within
PARAM_RTOL of |p| (a last-ulp rounding flip of ``p - lr (u + wd p)``),
except *proven ties*: Adam's first step moves a parameter by about
``lr · g / (|g| + eps)``, so an element whose gradient sits at the two
frameworks' rounding noise may move up to 2 lr apart.  Such a split is
allowed only where the reference's gradient is at most TIE_FACTOR times
the noise measured on that leaf (the largest |g_port − g_ref| there).
8-bit moments agree within one quantization step, the float moments
within 2·GRAD_RTOL of their leaf's largest value."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.launch import serve as j_serve
from repro.launch import steps as JST
from repro.models import model as JM
from repro.optim import OptConfig as JOptConfig
from repro.optim import init_opt_state as j_init_opt_state
from repro_torch import convert as C
from repro_torch import tree as T
from repro_torch.configs import base as TB
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as ST
from repro_torch.models import model as TM
from repro_torch.optim import OptConfig, init_opt_state

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6        # float32, another summation order
# caches: the SSD scan's exp / cumsum / einsum orders (as
# tests/test_torch_ssm.py), through up to 8 layers (jamba's period)
CACHE_RTOL, CACHE_ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
PARAM_RTOL = 5e-7
TIE_FACTOR = 10.0
ARCHS = ("llama3_2_1b", "phi4_mini_3_8b", "stablelm_1_6b", "stablelm_12b",
         "qwen3_moe_30b_a3b", "kimi_k2_1t_a32b", "mamba2_1_3b",
         "jamba_1_5_large_398b", "llama3_2_vision_11b", "musicgen_large")
NEW_ARCHS = ARCHS[4:]            # with MoE, SSM or cross layers, or audio
GATE = 0.5                       # the cross layers' gate in these tests
# full-size parameter counts: tests/test_archs.py's ranges
PARAM_RANGES = {"llama3_2_1b": (1.0e9, 1.8e9),
                "phi4_mini_3_8b": (3.0e9, 4.6e9),
                "stablelm_1_6b": (1.2e9, 2.1e9),
                "stablelm_12b": (10e9, 14e9),
                "qwen3_moe_30b_a3b": (25e9, 34e9),
                "kimi_k2_1t_a32b": (0.9e12, 1.15e12),
                "jamba_1_5_large_398b": (330e9, 430e9),
                "mamba2_1_3b": (1.0e9, 1.6e9),
                "musicgen_large": (1.4e9, 2.6e9),
                "llama3_2_vision_11b": (8.5e9, 12e9)}
FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "d_ff", "vocab", "rope_theta", "norm_eps", "act",
          "tie_embeddings", "frontend", "n_img_tokens", "n_codebooks",
          "param_dtype", "act_dtype", "remat",
          "remat_policy", "loss_vocab_chunk", "approx_matmul", "attn_impl",
          "attn_block_q", "attn_block_kv", "hd", "n_periods")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    jmod, tmod = JB.get_arch(arch), TB.get_arch(arch)
    assert tmod.OPTIMIZER == jmod.OPTIMIZER
    for jc, tc in ((jmod.CONFIG, tmod.CONFIG),
                   (jmod.reduced(), tmod.reduced())):
        for f in FIELDS:
            assert getattr(tc, f) == getattr(jc, f), (arch, f)
        assert [(s.kind, s.moe, s.cross_attn, s.has_ffn) for s in tc.period
                ] == [(s.kind, s.moe, s.cross_attn, s.has_ffn)
                      for s in jc.period]
        assert dataclasses.asdict(tc.moe) == dataclasses.asdict(jc.moe)
        assert dataclasses.asdict(tc.ssm) == dataclasses.asdict(jc.ssm)
        assert str(tc.pdtype()).split(".")[-1] == jc.param_dtype


def test_ported_and_unported_architectures():
    """All ten architectures are ported; an unknown id raises; the shape
    cells are the reference's."""
    assert TB.PORTED == TB.ARCH_IDS == JB.ARCH_IDS
    assert set(TB.ARCH_IDS) == set(ARCHS)
    for arch in ARCHS:
        assert TB.get_arch(arch).CONFIG.name == JB.get_arch(arch).CONFIG.name
    with pytest.raises(ValueError, match="unknown"):
        TB.get_arch("llama3_2_vision_90b")
    as_tuple = lambda s: (s.name, s.seq_len, s.global_batch, s.mode)
    assert [as_tuple(s) for s in TB.ALL_SHAPES] == [as_tuple(s)
                                                     for s in JB.ALL_SHAPES]
    assert TB.SUBQUADRATIC == JB.SUBQUADRATIC
    for arch in ARCHS:
        assert [s.name for s in TB.shapes_for(arch)] == [
            s.name for s in JB.shapes_for(arch)]


def _with_gate(jp, jcfg):
    """The reference's parameters with every cross layer's gate at GATE."""
    for i, spec in enumerate(jcfg.period):
        mix = jp["layers"][f"layer{i}"]["mixer"]
        if spec.cross_attn:
            mix["gate"] = jnp.full_like(mix["gate"], GATE)
    return jp


def _models(arch):
    jcfg = dataclasses.replace(JB.get_arch(arch).reduced(),
                               scan_layers=False)
    tcfg = TB.get_arch(arch).reduced()
    jp = _with_gate(JM.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    return jcfg, tcfg, jp, C.model_params(jp, tcfg)


def _tokens(cfg, seed, shape):
    """Random token ids of ``shape`` (B, S), with the codebook axis for
    audio."""
    if cfg.frontend == "audio":
        shape = shape + (cfg.n_codebooks,)
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def _embeds(cfg, batch, seed=5):
    """Random image embeddings (batch, n_img_tokens, d_model) for the
    vision front end, as (numpy, port tensor); (None, None) otherwise."""
    if cfg.frontend != "vision":
        return None, None
    x = np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return x, torch.as_tensor(x)


def _reference_embeds(monkeypatch, jp, img):
    """The reference's launchers (``serve._serve_loop``,
    ``quality_report``) on ``jp`` (their own draw is PRNGKey(0)'s, GATE
    aside) and, for vision, ``img`` in place of their zero embeddings."""
    monkeypatch.setattr(JM, "init_params", lambda key, cfg: jp)
    if img is None:
        return
    for name in ("prefill", "lm_loss"):
        real = getattr(JM, name)
        monkeypatch.setattr(JM, name, lambda *a, _r=real, image_embeds,
                            **kw: _r(*a, image_embeds=jnp.asarray(img)
                                     [:image_embeds.shape[0]], **kw))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    assert ("lm_head" in jp) == (not tcfg.tie_embeddings)
    toks = _tokens(jcfg, 1, (2, 24))
    ji, ti = _embeds(jcfg, 2)
    want, jaux = JM.forward_train(jp, jnp.asarray(toks), jcfg,
                                  image_embeds=ji)
    with torch.no_grad():
        got, taux = TM.forward_train(
            tp, torch.as_tensor(toks, dtype=torch.int64), tcfg, ti)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    assert (float(taux) > 0) == any(s.moe for s in tcfg.period)
    wl = float(JM.lm_loss(jp, jnp.asarray(toks), jnp.asarray(toks), jcfg,
                          image_embeds=ji))
    with torch.no_grad():
        tl = float(TM.lm_loss(tp, torch.as_tensor(toks, dtype=torch.int64),
                              torch.as_tensor(toks, dtype=torch.int64),
                              tcfg, ti))
    assert tl == pytest.approx(wl, rel=1e-6)
    # the other way: the port's parameters in the reference's tree
    back = C.reference_params(tp, tcfg)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_serve_matches_reference(arch, monkeypatch):
    """The greedy continuous-batching loop on the same weights: the
    reference's tokens (fp32, blocked attention; audio: codebook 0 of
    each step, all four fed back)."""
    jcfg, tcfg, jp, tp = _models(arch)
    n_req, prompt, gen, slots = 4, 16, 8, 2
    ji, ti = _embeds(jcfg, slots)
    _reference_embeds(monkeypatch, jp, ji)
    want = j_serve._serve_loop(jcfg, n_req, prompt, gen, slots, 0)
    got = t_serve._serve_loop(tcfg, tp, n_req, prompt, gen, slots, 0, "cpu",
                              ti)
    assert got["decoded_tokens"] == want["decoded_tokens"] == n_req * gen
    assert got["outputs"] == {k: list(v) for k, v in want["outputs"].items()}


def _close_trees(got, want):
    g, w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32),
                                   rtol=CACHE_RTOL, atol=CACHE_ATOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_reduced_prefill_decode_and_caches(arch):
    """Prefill and three decode steps: the reference's logits, and its
    caches (KV dicts, cross layers' K/V of the embeddings, SSM states)
    carried across both ways by ``convert.cache`` /
    ``convert.reference_cache``."""
    jcfg, tcfg, jp, tp = _models(arch)
    toks = _tokens(jcfg, 2, (2, 12))
    ji, ti = _embeds(jcfg, 2)
    jl, jc = JM.prefill(jp, jnp.asarray(toks), jcfg, max_len=16,
                        image_embeds=ji)
    tl, tc = TM.prefill(tp, torch.as_tensor(toks, dtype=torch.int64), tcfg,
                        max_len=16, image_embeds=ti)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)
    kinds = {type(c).__name__ for c in tc}
    assert kinds == ({"SSMState"} if arch == "mamba2_1_3b" else {"dict"}
                     if "ssm" not in {s.kind for s in tcfg.period}
                     else {"SSMState", "dict"})
    _close_trees(C.reference_cache(tc, tcfg), jc)
    # decode from the reference's cache, carried across
    pc = C.cache(jc, tcfg)
    pos = np.full((2,), 12, np.int32)
    tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
    assert tok.shape == ((2, 1, jcfg.n_codebooks) if jcfg.n_codebooks
                         else (2, 1))
    for _ in range(3):
        jl, jc = JM.decode_step(jp, jc, jnp.asarray(tok), jnp.asarray(pos),
                                jcfg)
        tl, pc = TM.decode_step(tp, pc, torch.tensor(tok).long(),
                                torch.tensor(pos).long(), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
        tok = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None]
        pos = pos + 1
    _close_trees(C.reference_cache(pc, tcfg), jc)


def _lut():
    rng = np.random.default_rng(1)
    exact = np.arange(256)[:, None] * np.arange(256)[None, :]
    return np.clip(exact + rng.integers(-40, 41, exact.shape),
                   0, 65535).astype(np.int32)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_reduced_quality_report_matches_reference(arch, monkeypatch):
    """``quality_report`` on an approximate table (attention, cross K/V
    and SSM projections through it, the experts and the audio head exact,
    as in the reference): the reference's perplexities within rtol 1e-4,
    as for llama (``test_torch_serve``)."""
    _, tcfg, jp, tp = _models(arch)
    lut = _lut()
    ji, ti = _embeds(tcfg, 4)
    _reference_embeds(monkeypatch, jp, ji)
    want = j_serve.quality_report(arch, lut, seq_len=16)
    shape = (4, 16) + ((tcfg.n_codebooks,) if tcfg.n_codebooks else ())
    toks = jax.random.randint(jax.random.PRNGKey(0), shape, 0, tcfg.vocab)
    got = t_serve.quality_report(
        arch, lut, device="cpu", params=tp,
        tokens=torch.as_tensor(np.array(toks), dtype=torch.int64),
        image_embeds=ti)
    for k in ("ppl_fp32", "ppl_int8", "ppl_approx"):
        assert np.isfinite(got[k])
        assert got[k] == pytest.approx(want[k], rel=1e-4), k
    for k in ("logit_mae_vs_fp32", "logit_mae_vs_int8"):
        assert got[k] == pytest.approx(want[k], rel=1e-3), k


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_shapes_without_allocation(arch):
    """The full-size ``skeleton`` on the ``meta`` device: every leaf's
    shape and dtype the reference's (``jax.eval_shape`` of its
    ``init_params``), and the parameter count in ``tests/test_archs.py``'s
    range."""
    tcfg = TB.get_arch(arch).CONFIG
    jcfg = JB.get_arch(arch).CONFIG
    sk = TM.skeleton(tcfg, "meta")
    ref = jax.eval_shape(lambda k: JM.init_params(k, jcfg),
                         jax.random.PRNGKey(0))
    own = dict(sk.named_parameters())
    assert all(p.device.type == "meta" for p in own.values())
    for name, slot, _, part, key in C._layer_names(tcfg):
        leaf = ref["layers"][slot][part][key]
        assert tuple(leaf.shape[1:]) == tuple(own[name].shape), name
        assert str(leaf.dtype) == str(own[name].dtype).split(".")[-1], name
    n = sum(p.numel() for p in own.values())
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(ref))
    lo, hi = PARAM_RANGES[arch]
    assert lo <= n <= hi, (arch, f"{n:.3e}")


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "stablelm_12b"])
def test_untied_head(arch):
    """``lm_head`` is drawn after the layers (N(0, 0.02²)), so the other
    parameters are the tied model's draws, and the logits read it, not
    the embedding."""
    cfg = TB.get_arch(arch).reduced()
    tied = dataclasses.replace(cfg, tie_embeddings=True)
    p = TM.init_params(torch.Generator().manual_seed(3), cfg)
    q = TM.init_params(torch.Generator().manual_seed(3), tied)
    assert not hasattr(q, "lm_head")
    assert p.lm_head.shape == (cfg.d_model, cfg.vocab)
    assert float(p.lm_head.std()) == pytest.approx(0.02, rel=0.05)
    own, other = dict(p.named_parameters()), dict(q.named_parameters())
    assert set(own) - set(other) == {"lm_head"}
    for n, b in other.items():
        assert torch.equal(own[n], b), n
    x = torch.randn((2, 3, cfg.d_model), generator=torch.Generator()
                    .manual_seed(4))
    with torch.no_grad():
        assert torch.equal(TM.logits_from_hidden(p, x, cfg),
                           x @ p.lm_head)
        assert torch.equal(TM.logits_from_hidden(q, x, tied),
                           x @ q.embed.tokens.T)


# ------------------------------ one train step ------------------------------

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


def _check_params(jp, tp, jg, noise, lr):
    """Parameters within PARAM_RTOL, or split at a proven tie; returns the
    number of ties."""
    ties = 0
    for a, b, g, n in zip(_leaves(jp), _leaves(tp), _leaves(jg), noise):
        assert a.shape == b.shape and a.dtype == b.dtype
        d = np.abs(a.astype(np.float64) - b)
        split = d > PARAM_RTOL * np.abs(a) + 1e-3 * lr
        assert (np.abs(g[split]) <= TIE_FACTOR * n).all(), (
            a.shape, np.abs(g[split]).max(), n)
        assert (d[split] <= 2.2 * lr).all()
        ties += int(split.sum())
    return ties


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One ``make_train_step`` with the configuration's ``OPTIMIZER``: the
    loss, the gradients, the new parameters and the new state against
    ``repro.launch.steps.make_train_step``."""
    jcfg = JB.get_arch(arch).reduced()
    tcfg = TB.get_arch(arch).reduced()
    jp = _with_gate(JM.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    name = JB.get_arch(arch).OPTIMIZER
    assert TB.get_arch(arch).OPTIMIZER == name
    b = synth_batch(DataConfig(vocab=jcfg.vocab, seq_len=64,
                               global_batch=8,
                               n_codebooks=jcfg.n_codebooks), 0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in b.items()}
    ji, ti = _embeds(jcfg, 8)
    if ji is not None:
        jb["image_embeds"], tb["image_embeds"] = jnp.asarray(ji), ti
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.lm_loss(p, jb["tokens"], jb["targets"], jcfg,
                             image_embeds=jb.get("image_embeds"))))(jp)
    tloss, tg = ST.loss_and_grads(C.model_params(jp, tcfg), tcfg,
                                  tb["tokens"], tb["targets"],
                                  image_embeds=ti)
    assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_RTOL)
    noise = _check_grads(jg, tg)

    jo, to = JOptConfig(name=name), OptConfig(name=name)
    tp = C.model_params(jp, tcfg)
    jp2, js2, jm = jax.jit(JST.make_train_step(jcfg, jo))(
        jp, j_init_opt_state(jp, jo), jb, jnp.int32(0))
    tp2, ts2, tm = ST.make_train_step(tcfg, to)(
        tp, init_opt_state(C.reference_tree(tp, tcfg), to), tb, 0)
    assert tp2 is tp
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                              rel=LOSS_RTOL)
    lr = to.lr / to.warmup_steps
    ties = _check_params(jp2, C.reference_params(tp2, tcfg), jg, noise, lr)
    assert ties <= 1e-4 * sum(p.numel() for p in tp.parameters())
    want, got = _leaves(js2), _leaves(ts2)
    assert [(a.shape, a.dtype) for a in want] == [(b.shape, b.dtype)
                                                   for b in got]
    for a, b in zip(want, got):
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b).max() <= 1
            assert (a != b).mean() < 0.01
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=2 * GRAD_RTOL
                                       * np.abs(a).max())
