"""The port's Mamba-2 mixer (``repro_torch.models.ssm``) on the CPU against
the JAX package's (``repro.models.ssm``), on the same numpy-seeded inputs
and the same weights, in float32.

The causal depthwise conv is the same sum of shifted products in the same
order: within CONV_RTOL (a fused multiply-add on either side may round
once less).  The SSD scan, the mixer and its decode step sum in other
orders than XLA's: within RTOL / ATOL of the reference, and, as the
reference's own tests hold, within 2e-4 of the naive recurrence and of the
forward (decode against forward).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SSMConfig as JSSMConfig
from repro.models import ssm as JSSM
from repro_torch.configs.base import LayerSpec, ModelConfig, SSMConfig
from repro_torch.convert import to_tensor
from repro_torch.models import ssm as TSSM

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

CONV_RTOL, CONV_ATOL = 1e-6, 1e-6
RTOL, ATOL = 1e-4, 1e-5        # float32 SSD: exp / cumsum / einsum orders
NAIVE_TOL = 2e-4               # the reference's tests/test_models.py


def _cfgs(d=32, d_state=8, headdim=8, chunk=8, conv_width=3, n_groups=1):
    kw = dict(n_layers=1, d_model=d, n_heads=4, n_kv_heads=4, vocab=64)
    sk = dict(d_state=d_state, headdim=headdim, chunk=chunk,
              conv_width=conv_width, n_groups=n_groups)
    return (JModelConfig(period=(JLayerSpec(kind="ssm", has_ffn=False),),
                         ssm=JSSMConfig(**sk), **kw),
            ModelConfig(period=(LayerSpec(kind="ssm", has_ffn=False),),
                        ssm=SSMConfig(**sk), **kw))


def _block(jp, tcfg) -> TSSM.SSM:
    """The reference's SSM leaves in the port's module."""
    p = TSSM.SSM(tcfg, "cpu")
    with torch.no_grad():
        for name, w in p.named_parameters():
            w.copy_(to_tensor(jp[name], w.dtype))
    return p


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("with_tail", [False, True])
@pytest.mark.parametrize("convw", [2, 4])
def test_causal_depthwise_conv(with_tail, convw):
    rng = np.random.default_rng(convw)
    x = rng.standard_normal((2, 11, 6)).astype(np.float32)
    w = rng.standard_normal((convw, 6)).astype(np.float32)
    tail = (rng.standard_normal((2, convw - 1, 6)).astype(np.float32)
            if with_tail else None)
    want = JSSM._causal_depthwise_conv(
        jnp.asarray(x), jnp.asarray(w),
        None if tail is None else jnp.asarray(tail))
    got = TSSM._causal_depthwise_conv(_t(x), _t(w),
                                      None if tail is None else _t(tail))
    _close(got, want, CONV_RTOL, CONV_ATOL)
    # causal: an output never reads a later input
    x2 = x.copy()
    x2[:, 7:] += 1.0
    got2 = TSSM._causal_depthwise_conv(_t(x2), _t(w),
                                       None if tail is None else _t(tail))
    assert torch.equal(got2[:, :7], got[:, :7])


def _naive_ssd(xh, dt, A, Bm, Cm):
    """The per-step recurrence in float64 (the reference test's oracle)."""
    B, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Bh = np.repeat(Bm, rep, axis=2).astype(np.float64)
    Ch = np.repeat(Cm, rep, axis=2).astype(np.float64)
    state = np.zeros((B, H, P, N))
    ys = np.zeros((B, S, H, P))
    for t in range(S):
        dA = np.exp(dt[:, t] * A[None, :])
        state = state * dA[:, :, None, None] + np.einsum(
            "bh,bhp,bhn->bhpn", dt[:, t], xh[:, t], Bh[:, t])
        ys[:, t] = np.einsum("bhn,bhpn->bhp", Ch[:, t], state)
    return ys, state


def _ssd_inputs(B=2, S=24, H=4, P=8, G=2, N=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, size=(B, S, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32),
            rng.normal(size=(B, S, G, N)).astype(np.float32))


@pytest.mark.parametrize("chunk", [4, 8, 16, 24, 7, 64])
def test_ssd_chunked(chunk):
    """Several chunk sizes (7 pads the sequence, 64 is one chunk): the
    reference's output and final state, and the naive recurrence."""
    args = _ssd_inputs()
    y, state = TSSM._ssd_chunked(*map(_t, args), chunk)
    jy, jstate = JSSM._ssd_chunked(*map(jnp.asarray, args), chunk)
    _close(y, jy)
    _close(state, jstate)
    y_ref, state_ref = _naive_ssd(*args)
    _close(y, y_ref, NAIVE_TOL, NAIVE_TOL)
    _close(state, state_ref, NAIVE_TOL, NAIVE_TOL)


def test_ssd_backward_where_the_triangle_overflows():
    """A chunk whose masked triangle overflows exp (seg up to ~760 here;
    mamba2-1.3b's chunk of 256 reaches thousands at its init): the forward
    is the reference's, but the reference's ``where(tri, exp(seg), 0)``
    takes inf · 0 = NaN into the gradients of dt and A, where the port's
    (the exp of the masked seg) are finite and equal the reference's at a
    chunk of 8, which does not overflow (ROADMAP, facts about the
    reference, 8)."""
    rng = np.random.default_rng(4)
    xh, Bm, Cm = (rng.normal(size=s).astype(np.float32)
                  for s in ((1, 64, 2, 4), (1, 64, 1, 4), (1, 64, 1, 4)))
    dt = rng.uniform(0.1, 0.2, size=(1, 64, 2)).astype(np.float32)
    A = np.array([-40.0, -60.0], np.float32)
    wy = rng.normal(size=(1, 64, 2, 4)).astype(np.float32)

    def ref_grads(chunk):
        loss = lambda d, a: jnp.sum(JSSM._ssd_chunked(
            jnp.asarray(xh), d, a, jnp.asarray(Bm), jnp.asarray(Cm),
            chunk)[0] * wy)
        return [np.asarray(g) for g in jax.grad(loss, (0, 1))(
            jnp.asarray(dt), jnp.asarray(A))]
    d, a = _t(dt).requires_grad_(), _t(A).requires_grad_()
    y, _ = TSSM._ssd_chunked(_t(xh), d, a, _t(Bm), _t(Cm), 64)
    _close(y, JSSM._ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)),
                                64)[0])
    (y * _t(wy)).sum().backward()
    assert not all(np.isfinite(g).all() for g in ref_grads(64))
    for got, want in zip((d.grad, a.grad), ref_grads(8)):
        assert bool(torch.isfinite(got).all())
        _close(got, want, NAIVE_TOL, NAIVE_TOL)


def test_ssd_chunked_carries_an_initial_state():
    xh, dt, A, Bm, Cm = map(_t, _ssd_inputs(S=32, seed=3))
    y, s = TSSM._ssd_chunked(xh, dt, A, Bm, Cm, 8)
    y1, s1 = TSSM._ssd_chunked(xh[:, :20], dt[:, :20], A, Bm[:, :20],
                               Cm[:, :20], 8)
    y2, s2 = TSSM._ssd_chunked(xh[:, 20:], dt[:, 20:], A, Bm[:, 20:],
                               Cm[:, 20:], 8, init_state=s1)
    _close(torch.cat([y1, y2], 1), y.numpy(), NAIVE_TOL, NAIVE_TOL)
    _close(s2, s.numpy(), NAIVE_TOL, NAIVE_TOL)
    jy, js = JSSM._ssd_chunked(*(jnp.asarray(a[:, 20:].numpy())
                                 if a.dim() > 1 else jnp.asarray(a.numpy())
                                 for a in (xh, dt, A, Bm, Cm)), 8,
                               init_state=jnp.asarray(s1.numpy()))
    _close(y2, jy)
    _close(s2, js)


@pytest.fixture(scope="module", params=[(8, 3, 1), (16, 4, 2)],
                ids=["chunk8-conv3", "chunk16-conv4-groups2"])
def block(request):
    chunk, convw, groups = request.param
    jcfg, tcfg = _cfgs(chunk=chunk, conv_width=convw, n_groups=groups)
    jp = JSSM.init_ssm(jax.random.PRNGKey(chunk), jcfg)
    return jcfg, tcfg, jp, _block(jp, tcfg)


def test_ssm_forward_with_state(block):
    jcfg, tcfg, jp, tp = block
    x = np.random.default_rng(4).standard_normal((2, 17, 32)).astype(
        np.float32)
    want, jst = JSSM.ssm_forward(jp, jnp.asarray(x), jcfg, return_state=True)
    got, st = TSSM.ssm_forward(tp, _t(x), tcfg, return_state=True)
    _close(got, want)
    for f in TSSM.SSMState._fields:
        _close(getattr(st, f), getattr(jst, f))
    out, none = TSSM.ssm_forward(tp, _t(x), tcfg)
    assert none is None and torch.equal(out, got)
    # the state continues the sequence: forward over the rest from it
    x2 = np.random.default_rng(5).standard_normal((2, 9, 32)).astype(
        np.float32)
    full, _ = TSSM.ssm_forward(tp, _t(np.concatenate([x, x2], 1)), tcfg)
    rest, _ = TSSM.ssm_forward(tp, _t(x2), tcfg, state=st)
    _close(rest, full[:, 17:].numpy(), NAIVE_TOL, NAIVE_TOL)
    jrest, _ = JSSM.ssm_forward(jp, jnp.asarray(x2), jcfg, state=jst)
    _close(rest, jrest)


def test_ssm_decode_step_matches_forward(block):
    """Token-by-token decode from a zeroed state equals the forward (the
    reference's ``test_ssm_decode_matches_forward``), and each step equals
    the reference's step on the same state."""
    jcfg, tcfg, jp, tp = block
    B, S = 2, 17
    x = np.random.default_rng(6).standard_normal((B, S, 32)).astype(
        np.float32)
    full, _ = TSSM.ssm_forward(tp, _t(x), tcfg)
    state = TSSM.init_ssm_state(tcfg, B, torch.float32)
    jstate = JSSM.init_ssm_state(jcfg, B, jnp.float32)
    assert [tuple(a.shape) for a in state] == [a.shape for a in jstate]
    outs = []
    for t in range(S):
        y, state = TSSM.ssm_decode_step(tp, _t(x[:, t:t + 1]), state, tcfg)
        jy, jstate = JSSM.ssm_decode_step(jp, jnp.asarray(x[:, t:t + 1]),
                                          jstate, jcfg)
        _close(y, jy)
        for f in TSSM.SSMState._fields:
            _close(getattr(state, f), getattr(jstate, f))
        outs.append(y)
    _close(torch.cat(outs, 1), full.numpy(), NAIVE_TOL, NAIVE_TOL)


def test_init_ssm_distributions():
    jcfg, tcfg = (dataclasses.replace(c, param_dtype="bfloat16")
                  for c in _cfgs(d=256, d_state=16, headdim=16))
    p = TSSM.init_ssm(torch.Generator().manual_seed(0), tcfg, "cpu")
    d_inner, H, P, G, N = TSSM.dims(tcfg)
    assert (d_inner, H) == (512, 32)
    s = tcfg.ssm
    dt = torch.nn.functional.softplus(p.dt_bias.float())
    # bfloat16 rounding of the bias moves softplus by up to ~1%
    assert float(dt.min()) >= 0.99 * s.dt_min
    assert float(dt.max()) <= 1.01 * s.dt_max
    assert torch.equal(p.a_log, torch.log(torch.arange(
        1, H + 1, dtype=torch.float32)).to(torch.bfloat16))
    assert float(p.conv_x_w.float().std()) == pytest.approx(0.1, rel=0.1)
    assert float(p.w_x.float().std()) == pytest.approx(256 ** -0.5,
                                                       rel=0.05)
    # the reference's shapes and dtypes
    jp = jax.eval_shape(lambda k: JSSM.init_ssm(k, jcfg),
                        jax.random.PRNGKey(0))
    assert set(jp) == {n for n, _ in p.named_parameters()}
    for name, w in p.named_parameters():
        assert tuple(jp[name].shape) == tuple(w.shape), name
        assert str(jp[name].dtype) == str(w.dtype).split(".")[-1], name
