"""The port's dense LM on the CPU against the JAX package, on the same
weights (``convert.model_params``): the reduced ``llama3_2_1b`` in float32.

Float paths agree to float32 reduction-order noise (RTOL/ATOL below).  The
approximate-multiplier matmul on one input has bit-identical quantized
operands and integer accumulator, and outputs within rtol 1e-6.  Through
the whole model a last-ulp difference (``rsqrt``, ``exp``, a sum order) can
put an activation on the other side of a rounding boundary, so a q may be
one step apart: at most Q_FLIP_FRACTION of them, never by more than 1, and
the logits agree within APPROX_ATOL.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import llama3_2_1b as JL
from repro.kernels import ref as j_ref
from repro.models import attention as JA
from repro.models import layers as JLay
from repro.models import model as JM
from repro.models import quant as JQ
from repro_torch import convert
from repro_torch.configs import base as B
from repro_torch.configs import llama3_2_1b as TL
from repro_torch.kernels import ops
from repro_torch.models import attention as TA
from repro_torch.models import layers as TLay
from repro_torch.models import model as TM
from repro_torch.models import quant as TQ

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6        # float32, another summation order
Q_FLIP_FRACTION = 1e-3         # q one step apart through the whole model
# logits through the whole approximate model where a q flipped: one flip
# moved the reduced model's logits by up to 0.022 in a teacher-forced
# replay of the serve loop (test_torch_serve)
APPROX_ATOL = 0.05
# downstream of attention on the flash path: the JAX kernel's 128-row
# online softmax and the port's plain naive softmax sum in orders further
# apart than the two blocked paths, and a layer later near-zero entries of
# O(1) tensors differ by up to ~4e-6
PALLAS_ATOL = 1e-5
B_, S_ = 4, 32


def _lut():
    rng = np.random.default_rng(1)
    exact = np.arange(256)[:, None] * np.arange(256)[None, :]
    return np.clip(exact + rng.integers(-40, 41, exact.shape),
                   0, 65535).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(JL.reduced(), scan_layers=False)
    tcfg = TL.reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.model_params(jp, tcfg)


@pytest.fixture(autouse=True)
def _no_lut():
    JQ.set_multiplier_lut(None)
    TQ.set_multiplier_lut(None)
    yield
    JQ.set_multiplier_lut(None)
    TQ.set_multiplier_lut(None)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def _tokens(seed=0, shape=(B_, S_), vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _t(a, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_weights_carried_across(models):
    jcfg, tcfg, jp, tp = models
    assert np.array_equal(tp.embed.tokens.numpy(), jp["embed"]["tokens"])
    assert np.array_equal(tp.layers[1].mixer.wq.numpy(),
                          jp["layers"]["layer0"]["mixer"]["wq"][1])
    assert np.array_equal(tp.layers[0].ffn.w_gate.numpy(),
                          jp["layers"]["layer0"]["ffn"]["w_gate"][0])
    assert all(not p.requires_grad for p in tp.parameters())


def test_rms_norm_and_rope(models):
    jcfg, tcfg, jp, tp = models
    x = _x((B_, S_, 64))
    scale = _x((64,), 1)
    _close(TLay.rms_norm(torch.as_tensor(x), torch.as_tensor(scale), 1e-5),
           JLay.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    pos = np.arange(S_)[None, :] + np.arange(B_)[:, None] * 5
    ts, tc = TLay.rope_angles(_t(pos), 8, 500000.0)
    js, jc = JLay.rope_angles(jnp.asarray(pos), 8, 500000.0)
    _close(ts, js)
    _close(tc, jc)
    q = _x((B_, S_, 8, 8), 2)
    _close(TLay.apply_rope(torch.as_tensor(q), ts, tc),
           JLay.apply_rope(jnp.asarray(q), js, jc))


@pytest.mark.parametrize("impl", ["blocked", "naive", "pallas"])
def test_self_attention_and_mlp(models, impl):
    jcfg, tcfg, jp, tp = models
    jcfg = dataclasses.replace(jcfg, attn_impl=impl, attn_block_q=8,
                               attn_block_kv=16)
    tcfg = dataclasses.replace(tcfg, attn_impl=impl, attn_block_q=8,
                               attn_block_kv=16)
    x = _x((B_, 30, 64), 3)               # ragged against both blocks
    jl = jax.tree.map(lambda a: a[0], jp["layers"])["layer0"]
    jo, (jk, jv) = JA.self_attention(jl["mixer"], jnp.asarray(x), jcfg)
    to, (tk, tv) = TA.self_attention(tp.layers[0].mixer, torch.as_tensor(x),
                                      tcfg)
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)
    _close(TLay.mlp(tp.layers[0].ffn, torch.as_tensor(x), tcfg),
           JLay.mlp(jl["ffn"], jnp.asarray(x), jcfg))


@pytest.mark.parametrize("B,S,H,Hkv,D,bq,bkv", [
    (2, 40, 4, 2, 8, 8, 16), (1, 64, 2, 1, 4, 16, 8), (2, 33, 2, 2, 8, 8, 8),
    (1, 20, 2, 2, 4, 32, 32)])
def test_blocked_attention_skips_masked_blocks_exactly(B, S, H, Hkv, D, bq,
                                                       bkv):
    """Skipping the causally masked key blocks changes no bit of the
    output or of its gradients against the loop over every block pair."""
    gen = torch.Generator().manual_seed(0)
    qkv = [torch.randn(shape, generator=gen, requires_grad=True)
           for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    outs, grads = [], []
    for skip in (True, False):
        out = TA.blocked_attention(*qkv, True, bq, bkv, skip_masked=skip)
        outs.append(out)
        grads.append(torch.autograd.grad((out * out).sum(), qkv))
    assert torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_decode_self_attention(models):
    jcfg, tcfg, jp, tp = models
    x = _x((B_, 1, 64), 4)
    kc, vc = _x((B_, 40, 2, 8), 5), _x((B_, 40, 2, 8), 6)
    pos = np.array([0, 7, 20, 39], np.int32)
    jl = jax.tree.map(lambda a: a[1], jp["layers"])["layer0"]
    jo, jk, jv = JA.decode_self_attention(jl["mixer"], jnp.asarray(x),
                                          jnp.asarray(kc), jnp.asarray(vc),
                                          jnp.asarray(pos), jcfg)
    to, tk, tv = TA.decode_self_attention(
        tp.layers[1].mixer, torch.as_tensor(x), torch.as_tensor(kc.copy()),
        torch.as_tensor(vc.copy()), _t(pos), tcfg)
    _close(to, jo)
    _close(tk, jk)
    _close(tv, jv)


def test_prefill_decode_and_loss(models):
    jcfg, tcfg, jp, tp = models
    toks = _tokens()
    jl, jc = JM.prefill(jp, jnp.asarray(toks), jcfg, max_len=S_ + 3)
    tl, tc = TM.prefill(tp, _t(toks), tcfg, max_len=S_ + 3)
    _close(tl, jl)
    for i, lc in enumerate(tc):
        _close(lc["k"], jc["layer0"]["k"][i])
        _close(lc["v"], jc["layer0"]["v"][i])
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    pos = np.full((B_,), S_, np.int32)
    jl2, jc2 = JM.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(pos),
                              jcfg)
    tl2, tc2 = TM.decode_step(tp, tc, _t(nxt), _t(pos), tcfg)
    _close(tl2, jl2)
    _close(tc2[1]["k"], jc2["layer0"]["k"][1])
    _close(TM.lm_loss(tp, _t(toks), _t(toks), tcfg),
           JM.lm_loss(jp, jnp.asarray(toks), jnp.asarray(toks), jcfg))
    # sequence-chunked cross-entropy, with a ragged tail left out
    toks = _tokens(1, (2, 37))
    jcc = dataclasses.replace(jcfg, loss_vocab_chunk=8)
    tcc = dataclasses.replace(tcfg, loss_vocab_chunk=8)
    _close(TM.lm_loss(tp, _t(toks), _t(toks), tcc),
           JM.lm_loss(jp, jnp.asarray(toks), jnp.asarray(toks), jcc))


def test_pallas_prefill_and_loss(models):
    """``attn_impl="pallas"``: the JAX package's flash kernel (interpret
    mode) against the port's ``ops.flash_attention`` (its plain version on
    the CPU), through prefill and ``lm_loss`` (``backbone``)."""
    jcfg, tcfg, jp, tp = models
    jcfg = dataclasses.replace(jcfg, attn_impl="pallas")
    tcfg = dataclasses.replace(tcfg, attn_impl="pallas")
    toks = _tokens(3)
    jl, jc = JM.prefill(jp, jnp.asarray(toks), jcfg, max_len=S_ + 2)
    tl, tc = TM.prefill(tp, _t(toks), tcfg, max_len=S_ + 2)
    _close(tl, jl, atol=PALLAS_ATOL)
    for i, lc in enumerate(tc):
        _close(lc["k"], jc["layer0"]["k"][i], atol=PALLAS_ATOL)
        _close(lc["v"], jc["layer0"]["v"][i], atol=PALLAS_ATOL)
    _close(TM.lm_loss(tp, _t(toks), _t(toks), tcfg),
           JM.lm_loss(jp, jnp.asarray(toks), jnp.asarray(toks), jcfg))
    # the same function as the blocked path, in another summation order
    blocked = dataclasses.replace(tcfg, attn_impl="blocked")
    _close(tl, TM.prefill(tp, _t(toks), blocked)[0], atol=PALLAS_ATOL)


def test_init_params_distributions():
    cfg = dataclasses.replace(TL.reduced(), d_model=128, d_ff=512,
                              vocab=2048)
    p = TM.init_params(torch.Generator().manual_seed(0), cfg)
    q = TM.init_params(torch.Generator().manual_seed(0), cfg)
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(),
                                                 q.parameters()))
    assert p.layers[0].mixer.wq.shape == (128, 8 * 8)
    assert float(p.layers[0].ffn.w_down.std()) == pytest.approx(
        512 ** -0.5, rel=0.05)
    assert float(p.layers[1].mixer.wk.std()) == pytest.approx(
        128 ** -0.5, rel=0.05)
    assert float(p.embed.tokens.std()) == pytest.approx(0.02, rel=0.05)
    assert torch.equal(p.final_norm, torch.ones(128))
    full = TL.CONFIG
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab, full.pdtype()) == (
        16, 2048, 32, 8, 8192, 128256, torch.bfloat16)


def test_other_architectures_raise():
    """Only an unknown architecture raises: the front ends' two resolve,
    and a cross-attention period builds, with a zero gate on each cross
    layer (initialized) or none allocated (``meta``)."""
    with pytest.raises(ValueError, match="unknown architecture"):
        B.get_arch("llama3_2_vision_90b")
    for arch in ("llama3_2_vision_11b", "musicgen_large"):
        assert B.get_arch(arch).CONFIG.frontend in ("vision", "audio")
    cfg = dataclasses.replace(TL.reduced(),
                              period=(B.LayerSpec(cross_attn=True),))
    p = TM.init_params(torch.Generator(), cfg)
    assert all(float(lp.mixer.gate) == 0.0 for lp in p.layers)
    sk = TM.skeleton(cfg, "meta")
    assert all(lp.mixer.gate.shape == () for lp in sk.layers)


@pytest.mark.parametrize("shape", [(B_ * S_, 64), (3, 5, 64)])
def test_approx_matmul_one_input(shape):
    lut = _lut()
    x, w = _x(shape, 8), _x((64, 96), 9, 0.1)
    jq, js, jz = JQ.quantize_u8(jnp.asarray(x.reshape(-1, 64)))
    tq, ts, tz = TQ.quantize_u8(torch.as_tensor(x.reshape(-1, 64)))
    assert tq.dtype == torch.uint8
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js) and tz.item() == float(jz)
    jqw, _, _ = JQ.quantize_u8(jnp.asarray(w))
    tqw, _, _ = TQ.quantize_u8(torch.as_tensor(w))
    acc = ops.lut_matmul(tq, tqw, torch.as_tensor(lut))
    assert np.array_equal(acc.numpy(), np.asarray(
        j_ref.lut_matmul_ref(jq, jqw, jnp.asarray(lut))))
    JQ.set_multiplier_lut(lut)
    TQ.set_multiplier_lut(lut)
    want = JQ.approx_matmul(jnp.asarray(x), jnp.asarray(w))
    got = TQ.approx_matmul(torch.as_tensor(x), torch.as_tensor(w))
    assert got.shape == shape[:-1] + (96,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))
    assert TQ.quant_error(torch.as_tensor(x), torch.as_tensor(w)) == \
        pytest.approx(JQ.quant_error(jnp.asarray(x), jnp.asarray(w)),
                      rel=1e-5)


def _record_q(monkeypatch, module, to_np):
    seen = []
    orig = module.quantize_u8

    def rec(x, axis=None, **kw):
        out = orig(x, axis, **kw)
        seen.append(to_np(out[0]).astype(np.int64))
        return out
    monkeypatch.setattr(module, "quantize_u8", rec)
    return seen


def test_approx_model_quantizes_alike(models, monkeypatch):
    """Prefill + one decode step through the approximate multiplier: the
    quantized operands of all 2 × 7 × 2 projections agree but for a few
    one-step flips, and the logits agree within APPROX_ATOL."""
    jcfg, tcfg, jp, tp = models
    jcfg = dataclasses.replace(jcfg, approx_matmul=True)
    tcfg = dataclasses.replace(tcfg, approx_matmul=True)
    lut = _lut()
    JQ.set_multiplier_lut(lut)
    TQ.set_multiplier_lut(lut)
    jq = _record_q(monkeypatch, JQ, np.asarray)
    tq = _record_q(monkeypatch, TQ, lambda t: t.numpy())
    toks = _tokens(2)
    jl, jc = JM.prefill(jp, jnp.asarray(toks), jcfg, max_len=S_ + 1)
    tl, tc = TM.prefill(tp, _t(toks), tcfg, max_len=S_ + 1)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    pos = np.full((B_,), S_, np.int32)
    jl2, _ = JM.decode_step(jp, jc, jnp.asarray(nxt), jnp.asarray(pos), jcfg)
    tl2, _ = TM.decode_step(tp, tc, _t(nxt), _t(pos), tcfg)
    assert len(jq) == len(tq) == 2 * 2 * 7 * 2
    flips = total = 0
    for a, b in zip(jq, tq):
        assert a.shape == b.shape
        d = np.abs(a - b)
        assert d.max() <= 1
        flips += int(d.sum())
        total += d.size
    assert flips <= Q_FLIP_FRACTION * total, (flips, total)
    atol = APPROX_ATOL if flips else 1e-5   # no flip: float noise only
    _close(tl, jl, rtol=0, atol=atol)
    _close(tl2, jl2, rtol=0, atol=atol)
