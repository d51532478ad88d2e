"""The port's MoE block (``repro_torch.models.moe``) on the CPU against the
JAX package's (``repro.models.moe``), on the same numpy-seeded inputs and
the same weights.

Integer outputs (expert ids, the dispatch's order, buffer rows and kept
mask) are equal.  Float32 outputs differ by summation order only: within
RTOL / ATOL.  Ties in the router's probabilities are planted with
integer-valued activations and router weights, whose logits are exact in
any summation order: the top k must then take the lower expert id first,
as ``jax.lax.top_k`` does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerSpec as JLayerSpec
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as JMOE
from repro_torch.configs.base import LayerSpec, ModelConfig, MoEConfig
from repro_torch.convert import to_tensor
from repro_torch.models import moe as TMOE

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6        # float32, another summation order


def _cfgs(E=4, K=2, d=16, f=8, cf=1.25, dtype="float32"):
    kw = dict(n_layers=1, d_model=d, vocab=8, param_dtype=dtype,
              act_dtype=dtype)
    j = JModelConfig(period=(JLayerSpec(moe=True),), moe=JMoEConfig(
        n_experts=E, top_k=K, d_ff_expert=f, capacity_factor=cf), **kw)
    t = ModelConfig(period=(LayerSpec(moe=True),), moe=MoEConfig(
        n_experts=E, top_k=K, d_ff_expert=f, capacity_factor=cf), **kw)
    return j, t


def _block(jp, tcfg) -> TMOE.MoE:
    """The reference's MoE leaves in the port's module."""
    p = TMOE.MoE(tcfg, "cpu")
    with torch.no_grad():
        for name, w in p.named_parameters():
            w.copy_(to_tensor(jp[name], w.dtype))
    return p


def _planted(T, D, E, seed):
    """Integer-valued activations and router: exact logits, many ties."""
    rng = np.random.default_rng(seed)
    h = rng.integers(-2, 3, (T, D)).astype(np.float32)
    r = rng.integers(-1, 2, (D, E)).astype(np.float32)
    r[:, 3] = r[:, 1]                       # two experts always tied
    return h, r


@pytest.mark.parametrize("T,D,E,K,seed", [(64, 8, 8, 2, 0), (48, 4, 16, 8, 1),
                                          (33, 6, 6, 3, 2)])
def test_route_ties_go_to_the_lower_expert(T, D, E, K, seed):
    h, r = _planted(T, D, E, seed)
    jw, jids, jaux = JMOE._route(jnp.asarray(h), jnp.asarray(r), K)
    tw, tids, taux = TMOE._route(torch.as_tensor(h), torch.as_tensor(r), K)
    logits = h @ r
    top = np.sort(logits, axis=1)[:, ::-1]
    # ties inside the top k and across its edge are both planted
    assert (top[:, :K - 1] == top[:, 1:K]).any()
    assert (top[:, K - 1] == top[:, K]).any()
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL,
                               atol=ATOL)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    # the lower id first among equal probabilities
    probs = torch.softmax(torch.as_tensor(logits), -1)
    chosen = torch.gather(probs, 1, tids)
    eq = chosen[:, :-1] == chosen[:, 1:]
    assert bool((tids[:, :-1][eq] < tids[:, 1:][eq]).all())


@pytest.mark.parametrize("seed", [0, 1])
def test_route_random(seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((40, 16)).astype(np.float32)
    r = (rng.standard_normal((16, 8)) / 4).astype(np.float32)
    jw, jids, jaux = JMOE._route(jnp.asarray(h), jnp.asarray(r), 2)
    tw, tids, taux = TMOE._route(torch.as_tensor(h), torch.as_tensor(r), 2)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL,
                               atol=ATOL)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)


@pytest.mark.parametrize("T,E,K,capacity", [(32, 4, 2, 5), (32, 4, 2, 32),
                                            (17, 8, 3, 1), (50, 16, 8, 7)])
def test_dispatch_indices(T, E, K, capacity):
    rng = np.random.default_rng(T + E)
    ids = np.stack([rng.permutation(E)[:K] for _ in range(T)]).astype(
        np.int32)
    jo, jb, jk = JMOE._dispatch_indices(jnp.asarray(ids), E, capacity)
    to, tb, tk = TMOE._dispatch_indices(torch.as_tensor(ids).long(), E,
                                        capacity)
    for got, want in ((to, jo), (tb, jb), (tk, jk)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    if capacity < T:
        assert not bool(tk.all())           # some assignments dropped


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("cf,E,K", [(0.25, 4, 2), (1.25, 8, 3),
                                    (2.0, 16, 8)])
def test_moe_ffn_matches_reference(full, cf, E, K):
    """``moe_ffn`` with drops (``capacity_factor`` 0.25, as the
    reference's ``tests/test_models.py`` drops) and at full capacity."""
    jcfg, tcfg = _cfgs(E=E, K=K, cf=cf)
    key = jax.random.PRNGKey(E)
    jp = JMOE.init_moe(key, jcfg)
    x = np.random.default_rng(E).standard_normal((2, 16, 16)).astype(
        np.float32)
    want, jaux = JMOE.moe_ffn(jp, jnp.asarray(x), jcfg, full_capacity=full)
    got, taux = TMOE.moe_ffn(_block(jp, tcfg), torch.as_tensor(x), tcfg,
                             full_capacity=full)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    if cf == 0.25 and not full:
        other, _ = TMOE.moe_ffn(_block(jp, tcfg), torch.as_tensor(x), tcfg,
                                full_capacity=True)
        assert float((got - other).abs().max()) > 1e-6     # drops happened


def test_combine_order_is_the_references_scatter_order():
    """In bfloat16 the combine equals, bit for bit, the reference's
    ``zeros.at[tok].add(...)`` applied one update at a time in
    sorted-by-expert order, each add rounded to bfloat16, and two runs are
    identical."""
    _, tcfg = _cfgs(E=8, K=4, d=32, f=16, cf=1.0, dtype="bfloat16")
    p = TMOE.init_moe(torch.Generator().manual_seed(0), tcfg, "cpu")
    h2 = torch.randn((40, 32), generator=torch.Generator().manual_seed(1)
                     ).to(torch.bfloat16)
    cap = TMOE._capacity(40, tcfg, False)
    got, _ = TMOE._moe_math(h2, p, tcfg, cap)
    again, _ = TMOE._moe_math(h2, p, tcfg, cap)
    assert torch.equal(got, again)
    # the reference's scatter formulation, on the port's pieces
    w, ids, _ = TMOE._route(h2, p.router, 4)
    order, buf_idx, keep = TMOE._dispatch_indices(ids, 8, cap)
    tok = order // 4
    idx = torch.where(keep, buf_idx, 8 * cap)
    buf = torch.zeros((8 * cap + 1, 32), dtype=h2.dtype)
    buf[idx[keep]] = h2[tok[keep]]
    out_buf = TMOE._expert_ffn(buf[:-1].reshape(8, cap, 32), p)
    out_buf = torch.cat([out_buf.reshape(-1, 32),
                         torch.zeros((1, 32), dtype=h2.dtype)])
    wk = w.reshape(-1)[order] * keep.float()
    contrib = out_buf[idx] * wk[:, None].to(h2.dtype)
    want = torch.zeros_like(h2)
    for j, t in enumerate(tok.tolist()):
        want[t] = want[t] + contrib[j]
    assert not bool(keep.all())
    assert torch.equal(got, want)


def test_init_moe_distributions():
    _, tcfg = _cfgs(E=4, K=2, d=256, f=128, dtype="bfloat16")
    p = TMOE.init_moe(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert p.router.dtype == torch.float32
    assert p.w_gate.dtype == torch.bfloat16
    assert (p.w_gate.shape, p.w_up.shape, p.w_down.shape) == (
        (4, 256, 128), (4, 256, 128), (4, 128, 256))
    for w, std in ((p.router, 256 ** -0.5), (p.w_gate, 256 ** -0.5),
                   (p.w_up, 256 ** -0.5), (p.w_down, 128 ** -0.5)):
        assert float(w.float().std()) == pytest.approx(std, rel=0.05)
    assert torch.equal(p.norm, torch.ones(256, dtype=torch.bfloat16))
    # the reference's shapes and dtypes
    jcfg = _cfgs(E=4, K=2, d=256, f=128, dtype="bfloat16")[0]
    jp = jax.eval_shape(lambda k: JMOE.init_moe(k, jcfg),
                        jax.random.PRNGKey(0))
    for name, w in p.named_parameters():
        assert tuple(jp[name].shape) == tuple(w.shape), name
        assert str(jp[name].dtype) == str(w.dtype).split(".")[-1], name
