"""The port's optimizers, schedule and gradient compression against the
JAX package (``repro.optim``), on the same numpy inputs.

Given the same gradients, AdamW and 8-bit AdamW give the reference's
parameters and state bit for bit wherever the learning rate is the same
float32 and the gradients are under the clipping norm.  ``lr_at`` computes the cosine with another library's ``cos``,
which may differ by one ulp; ``0.5 (1 + cos)`` near the end of the decay
magnifies that relative to the result, so the schedule is held within
LR_ATOL = 2^-22 · lr (two ulps of a number in [0.5, 1) scaled by lr) and
is bit for bit at most steps.  Adafactor's
row / column means sum in another order: within ADAFACTOR_RTOL.  Norms are
float32 sums in another order: within NORM_RTOL.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import compress as JC
from repro.optim import optimizer as JO
from repro.optim import schedule as JS
from repro_torch import tree as T
from repro_torch.optim import compress as TC
from repro_torch.optim import optimizer as TO
from repro_torch.optim import schedule as TS

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

ULP_RTOL = 2 ** -23            # one float32 ulp, relative
LR_ATOL = 2 ** -22             # times cfg.lr: the cosine's ulp, scaled
NORM_RTOL = 1e-6
ADAFACTOR_RTOL = 1e-6
STATE_RTOL = 2e-6              # state and parameters over clipped steps (2.3e-7 seen)
OPTIMIZERS = ("adamw", "adamw8bit", "adafactor")
# the reference's tree shapes: a stacked matrix, a stacked vector (which
# Adafactor factors across the stack), a plain vector and a scalar
SHAPES = {"layers": {"w": (3, 8, 5), "norm": (3, 6)}, "embed": (16, 4),
          "final_norm": (7,), "scale": ()}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return T.map(lambda s: (rng.standard_normal(s) * scale
                            ).astype(np.float32), SHAPES)


def _jax(tree):
    return T.map(jnp.asarray, tree)


def _torch(tree):
    return T.map(torch.as_tensor, tree)


def _np(tree):
    return T.map(lambda x: np.asarray(x) if not isinstance(x, torch.Tensor)
                 else x.numpy(), tree)


@pytest.mark.parametrize("warmup,total", [(10, 50), (100, 30), (1, 2)])
def test_lr_at_matches_reference(warmup, total):
    jc = JO.OptConfig(warmup_steps=warmup, total_steps=total)
    tc = TO.OptConfig(warmup_steps=warmup, total_steps=total)
    want = np.array([np.float32(JS.lr_at(s, jc)) for s in range(total + 1)])
    got = np.array([TS.lr_at(s, tc).item() for s in range(total + 1)],
                   np.float32)
    assert TS.lr_at(0, tc).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=ULP_RTOL,
                               atol=LR_ATOL * tc.lr)
    assert (got == want).mean() > 0.8


def test_global_norm_and_clipping_match_reference():
    g = _tree(0, 3.0)
    want = float(JO.global_norm(_jax(g)))
    got = float(TO.global_norm(_torch(g)))
    assert got == pytest.approx(want, rel=NORM_RTOL)
    for max_norm in (1.0, 1e3):
        jg, jn = JO.clip_by_global_norm(_jax(g), max_norm)
        tg, tn = TO.clip_by_global_norm(_torch(g), max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=NORM_RTOL)
        for a, b in zip(T.leaves(_np(jg)), T.leaves(_np(tg))):
            assert b.dtype == np.float32
            np.testing.assert_allclose(b, a, rtol=NORM_RTOL, atol=0)
    # under the limit the gradients are only cast
    tg, _ = TO.clip_by_global_norm(_torch(g), 1e3)
    for a, b in zip(T.leaves(g), T.leaves(_np(tg))):
        assert np.array_equal(a, b)


def _run_both(name, steps, scale):
    jc = JO.OptConfig(name=name, warmup_steps=2, total_steps=20)
    tc = TO.OptConfig(name=name, warmup_steps=2, total_steps=20)
    params = _tree(1)
    jp, tp = _jax(params), _torch(params)
    js, ts = JO.init_opt_state(jp, jc), TO.init_opt_state(tp, tc)
    assert [(a.shape, a.dtype) for a in T.leaves(_np(js))] == [
        (b.shape, b.dtype) for b in T.leaves(_np(ts))]
    for step in range(steps):
        g = _tree(10 + step, scale * (step + 1))
        jp, js = JO.apply_gradients(jp, _jax(g), js, jnp.int32(step), jc)
        tp, ts = TO.apply_gradients(tp, _torch(g), ts, step, tc)
        yield (step, T.leaves(_np(jp)) + T.leaves(_np(js)),
               T.leaves(_np(tp)) + T.leaves(_np(ts)))


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_steps_match_reference_on_the_same_gradients(name):
    """Three steps of gradients under the clipping norm, where the learning
    rate and both bias corrections are the same float32 in the two
    packages (checked): AdamW and 8-bit AdamW bit for bit."""
    cfg = TO.OptConfig(warmup_steps=2, total_steps=20)
    for step in range(3):
        assert np.float32(JS.lr_at(step, cfg)) == TS.lr_at(step, cfg).item()
        for b in (cfg.beta1, cfg.beta2):
            assert np.float32(b ** (jnp.int32(step) + 1)) == torch.pow(
                torch.tensor(b), torch.tensor(step + 1.0)).item()
    for step, want, got in _run_both(name, 3, 0.01):
        for a, b in zip(want, got):
            assert (a.shape, a.dtype) == (b.shape, b.dtype)
            if name == "adafactor":
                np.testing.assert_allclose(b, a, rtol=ADAFACTOR_RTOL,
                                           atol=0)
            else:
                assert np.array_equal(a, b), (name, step, a.shape)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_steps_track_reference_with_clipping(name):
    """Eight steps of gradients the global norm clips: the two norms and
    the bias corrections (XLA's ``pow`` against a correctly rounded one)
    may differ in the last bit, so the parameters and the float state
    agree within STATE_RTOL (relative, and of the leaf's largest value)
    and an 8-bit moment within one quantization step."""
    for step, want, got in _run_both(name, 8, 0.5):
        for a, b in zip(want, got):
            if a.dtype == np.int8:
                assert np.abs(a.astype(int) - b).max() <= 1
                assert (a != b).mean() < 0.05
            else:
                np.testing.assert_allclose(b, a, rtol=STATE_RTOL,
                                           atol=STATE_RTOL * np.abs(a).max())


def test_q8_matches_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 33)).astype(np.float32)
    x[1] = 0.0                                  # a zero row: the 1e-12 guard
    x[2, :4] = [1.0, -1.0, 0.25, -0.0]          # exact grid points
    x[3] *= 1e-20                               # rows far below one
    for arr in (x, x[0], np.float32(-2.5)):
        jq, js = JO._q8(jnp.asarray(arr))
        tq, ts = TO._q8(torch.as_tensor(arr))
        assert np.array_equal(np.asarray(jq), tq.numpy())
        assert np.array_equal(np.asarray(js), ts.numpy())
        assert np.array_equal(np.asarray(JO._dq8(jq, js, arr.shape)),
                              TO._dq8(tq, ts).numpy())


def _quadratic():
    target = np.random.default_rng(0).normal(size=(8, 8)).astype(np.float32)
    return {"w": torch.zeros((8, 8))}, torch.as_tensor(target)


def _grad(params, target):
    return {"w": 2 * (params["w"] - target)}


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizers_descend_quadratic(name):
    params, target = _quadratic()
    cfg = TO.OptConfig(name=name, lr=0.05, weight_decay=0.0, warmup_steps=1,
                       total_steps=200)
    state = TO.init_opt_state(params, cfg)
    loss = lambda p: float(((p["w"] - target) ** 2).sum())
    l0 = loss(params)
    for s in range(60):
        params, state = TO.apply_gradients(params, _grad(params, target),
                                           state, s, cfg)
    assert loss(params) < 0.2 * l0, name


def test_adamw8bit_tracks_fp_adamw():
    params, target = _quadratic()
    pa, pb = dict(params), dict(params)
    ca = TO.OptConfig(name="adamw", lr=0.05, weight_decay=0.0,
                      warmup_steps=1, total_steps=100)
    cb = TO.OptConfig(name="adamw8bit", lr=0.05, weight_decay=0.0,
                      warmup_steps=1, total_steps=100)
    sa, sb = TO.init_opt_state(pa, ca), TO.init_opt_state(pb, cb)
    for s in range(20):
        pa, sa = TO.apply_gradients(pa, _grad(pa, target), sa, s, ca)
        pb, sb = TO.apply_gradients(pb, _grad(pb, target), sb, s, cb)
    np.testing.assert_allclose(pb["w"].numpy(), pa["w"].numpy(), rtol=0.1,
                               atol=0.05)


def test_lr_schedule_shape():
    cfg = TO.OptConfig(lr=1.0, warmup_steps=10, total_steps=100,
                       min_lr_ratio=0.1)
    lrs = [TS.lr_at(s, cfg).item() for s in range(100)]
    assert lrs[0] < 0.2
    assert abs(max(lrs) - 1.0) < 0.01
    assert lrs[-1] < 0.2
    assert lrs[-1] >= 0.099


@pytest.mark.parametrize("shape", [(300,), (3, 7, 11), (256,), ()])
def test_quantize_leaf_matches_reference(shape):
    g = (np.random.default_rng(4).standard_normal(shape) * 3
         ).astype(np.float32)
    jq, js = JC.quantize_leaf(jnp.asarray(g))
    tq, ts = TC.quantize_leaf(torch.as_tensor(g))
    assert np.array_equal(np.asarray(jq), tq.numpy())
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(JC.dequantize_leaf(jq, js, shape)),
                          TC.dequantize_leaf(tq, ts, shape).numpy())


def test_compress_with_feedback_matches_reference():
    grads, err = _tree(5), T.map(lambda s: np.zeros(s, np.float32), SHAPES)
    jerr, terr = _jax(err), _torch(err)
    for _ in range(3):
        jq, jerr = JC.compress_with_feedback(_jax(grads), jerr)
        tq, terr = TC.compress_with_feedback(_torch(grads), terr)
        for a, b in zip(T.leaves(_np(jq)) + T.leaves(_np(jerr)),
                        T.leaves(_np(tq)) + T.leaves(_np(terr))):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_grad_compression_error_feedback_unbiased():
    rng = np.random.default_rng(0)
    g_true = {"w": torch.as_tensor(rng.normal(size=(300,)).astype(
        np.float32))}
    err = TC.init_error(g_true)
    acc = np.zeros(300, np.float32)
    n = 50
    for _ in range(n):
        qt, err = TC.compress_with_feedback(g_true, err)
        acc += TC.dequantize_leaf(qt["w"]["q"], qt["w"]["s"], (300,)).numpy()
    np.testing.assert_allclose(acc / n, g_true["w"].numpy(), rtol=0.02,
                               atol=0.005)


def _psum_rank(rank, world):
    torch.set_num_threads(1)
    g = {"w": torch.arange(world * 64, dtype=torch.float32).reshape(
        world, 64)[rank] / 100.0, "b": torch.full((3,), float(rank + 1))}
    e = TC.init_error(g)
    red, err = TC.compressed_psum(g, e)
    red2, _ = TC.compressed_psum(g, err)
    return ({k: v.numpy() for k, v in red.items()},
            {k: v.numpy() for k, v in err.items()},
            {k: v.numpy() for k, v in red2.items()})


def test_compressed_psum_on_two_gloo_ranks():
    """Every rank gets the mean of the ranks' dequantized gradients (the
    reference's ``psum`` / n on the same payloads) and keeps its own
    residual."""
    from repro_torch.parallel.spawn import run_ranks
    world = 2
    outs = run_ranks(_psum_rank, world, timeout_s=120.0)
    grads = [{"w": np.arange(world * 64, dtype=np.float32).reshape(
        world, 64)[r] / np.float32(100.0),
        "b": np.full((3,), float(r + 1), np.float32)} for r in range(world)]
    deq = []
    for g in grads:
        q, e = JC.compress_with_feedback(_jax(g), _jax(T.map(np.zeros_like,
                                                             g)))
        deq.append({k: np.asarray(JC.dequantize_leaf(q[k]["q"], q[k]["s"],
                                                      g[k].shape))
                    for k in g})
    for rank, (red, err, red2) in enumerate(outs):
        for k in ("w", "b"):
            want = (deq[0][k] + deq[1][k]) / np.float32(world)
            np.testing.assert_allclose(red[k], want, rtol=1e-6, atol=0)
            np.testing.assert_allclose(red[k], np.mean([g[k] for g in grads],
                                                       axis=0),
                                       rtol=0.02, atol=0.01)
            assert np.array_equal(err[k], grads[rank][k] - deq[rank][k])
            np.testing.assert_allclose(red2[k], red[k], rtol=0.02, atol=0.01)
    assert np.array_equal(outs[0][0]["w"], outs[1][0]["w"])
