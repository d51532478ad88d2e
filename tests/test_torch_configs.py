"""The port's dense configurations against the JAX package's:
``llama3_2_1b``, ``phi4_mini_3_8b``, ``stablelm_1_6b`` and ``stablelm_12b``
(both stablelms with an untied ``lm_head``).  Each reduced configuration's
forward on the reference's weights (``convert.model_params``) gives the
reference's logits within the float32 tolerance of ``test_torch_model``,
its greedy serve loop the reference's tokens, and one train step with its
``OPTIMIZER`` the reference's loss, gradients, parameters and state.

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
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
PARAM_RTOL = 5e-7
TIE_FACTOR = 10.0
ARCHS = ("llama3_2_1b", "phi4_mini_3_8b", "stablelm_1_6b", "stablelm_12b")
FIELDS = ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
          "head_dim", "d_ff", "vocab", "rope_theta", "norm_eps",
          "tie_embeddings", "param_dtype", "act_dtype", "remat",
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
        assert jc.act == "swiglu" and jc.frontend == "none"
        assert str(tc.pdtype()).split(".")[-1] == jc.param_dtype


def test_ported_and_unported_architectures():
    assert set(TB.PORTED) == set(ARCHS)
    for arch in set(TB.ARCH_IDS) - set(ARCHS):
        with pytest.raises(NotImplementedError):
            TB.get_arch(arch)
    assert TB.TRAIN_4K == TB.ShapeConfig(
        JB.TRAIN_4K.name, JB.TRAIN_4K.seq_len, JB.TRAIN_4K.global_batch,
        JB.TRAIN_4K.mode)


def _models(arch):
    jcfg = dataclasses.replace(JB.get_arch(arch).reduced(),
                               scan_layers=False)
    tcfg = TB.get_arch(arch).reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, C.model_params(jp, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_matches_reference(arch):
    jcfg, tcfg, jp, tp = _models(arch)
    assert ("lm_head" in jp) == (not tcfg.tie_embeddings)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 24),
                                             dtype=np.int32)
    want, _ = JM.forward_train(jp, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = TM.forward_train(tp, torch.as_tensor(toks, dtype=torch.int64),
                               tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    wl = float(JM.lm_loss(jp, jnp.asarray(toks), jnp.asarray(toks), jcfg))
    with torch.no_grad():
        tl = float(TM.lm_loss(tp, torch.as_tensor(toks, dtype=torch.int64),
                              torch.as_tensor(toks, dtype=torch.int64),
                              tcfg))
    assert tl == pytest.approx(wl, rel=1e-6)
    # the other way: the port's parameters in the reference's tree
    back = C.reference_params(tp, tcfg)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), b)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_serve_matches_reference(arch):
    """The greedy continuous-batching loop on the same weights: the
    reference's tokens (fp32, blocked attention)."""
    jcfg, tcfg, jp, tp = _models(arch)
    n_req, prompt, gen, slots = 4, 16, 8, 2
    want = j_serve._serve_loop(jcfg, n_req, prompt, gen, slots, 0)
    got = t_serve._serve_loop(tcfg, tp, n_req, prompt, gen, slots, 0, "cpu")
    assert got["decoded_tokens"] == want["decoded_tokens"] == n_req * gen
    assert got["outputs"] == {k: list(v) for k, v in want["outputs"].items()}


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
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    name = JB.get_arch(arch).OPTIMIZER
    assert TB.get_arch(arch).OPTIMIZER == name
    b = synth_batch(DataConfig(vocab=jcfg.vocab, seq_len=64,
                               global_batch=8), 0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v, dtype=torch.int64) for k, v in b.items()}
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.lm_loss(p, jb["tokens"], jb["targets"], jcfg)))(jp)
    tloss, tg = ST.loss_and_grads(C.model_params(jp, tcfg), tcfg,
                                  tb["tokens"], tb["targets"])
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
