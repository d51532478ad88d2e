"""The multi-device LM of the port over ``torch.distributed``, on gloo CPU
ranks (``parallel.spawn.run_ranks``), against the JAX package's sharded
runs on forced host devices.

The reference runs once, in a subprocess with 8 host devices
(``conftest.run_subprocess``), on meshes built with ``Auto`` axis types:
under the installed JAX ``jax.make_mesh`` defaults to explicit axes, where
the reference's sharded embedding gather raises.  It writes every result
the tests compare to a pickle, and a checkpoint of its sharded train run.
The port runs in three worlds of 8, 4 and 2 ranks, each building the
meshes it needs.

Tolerances are ``tests/test_torch_configs.py``'s float32 ones (RTOL,
ATOL) unless stated: the hybrid model's forward within 1e-3 (the
reference test's own bound); train losses within LOSS_RTOL.  Exact where
both are possible: the parameters, optimizer state and caches at rest are
the slices ``NamedSharding`` gives each device, bit for bit; a restored
checkpoint is the saved leaves' slices bit for bit; the approximate
multiplier's sharded projections are the unsharded ones bit for bit (the
quantization scale is taken over every rank's rows);
gloo's own all-gather and reduce-scatter over axis tuples give every
rank's block in order, bit for bit.
"""
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from conftest import run_subprocess

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
LOSS_RTOL = 1e-6
HYB_ATOL = 1e-3
Q_FLIP_FRACTION = 1e-3     # as chip_smoke.py's 8-bit moment flips
OPTS = ("adamw", "adamw8bit", "adafactor")
TRAIN_STEPS = 3
DEC_STEPS = 4

REF_SCRIPT = r'''
import dataclasses, pickle, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding
from repro.configs import base as B
from repro.configs.base import LayerSpec, MoEConfig, ModelConfig, SSMConfig
from repro.models import model as M
from repro.parallel import ctx
from repro.launch import steps as ST
from repro.optim import OptConfig, init_opt_state, opt_state_specs
from repro.data.pipeline import DataConfig, synth_batch
from repro.checkpoint import store

OUT, CKPT = {out!r}, {ckpt!r}
host = lambda t: jax.tree.map(np.asarray, t)

def mesh(shape):
    names = ("pod", "data", "model")[-len(shape):]
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])

def put(tree, specs):
    return jax.device_put(tree, ST.resolve_tree(specs))

out = {{}}
# the reference test's hybrid SSM + MoE model on (2, 2, 2)
cfg = ModelConfig(name='hyb', n_layers=4, d_model=64, n_heads=4,
                  n_kv_heads=2, d_ff=128, vocab=256,
                  period=(LayerSpec(kind='ssm'),
                          LayerSpec(kind='attn', moe=True)),
                  ssm=SSMConfig(d_state=16, headdim=16, chunk=8),
                  moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                                capacity_factor=2.0), remat=True)
key = jax.random.PRNGKey(0)
params = M.init_params(key, cfg)
toks = jax.random.randint(key, (8, 32), 0, cfg.vocab)
with ctx.use_mesh(mesh((2, 2, 2))):
    p_sh = put(params, M.param_specs(cfg))
    t_sh = jax.device_put(toks, ctx.named_sharding(('dp', None)))
    got, aux = jax.jit(lambda p, t: M.forward_train(p, t, cfg))(p_sh, t_sh)
out["hyb"] = dict(params=host(params), toks=np.asarray(toks),
                  logits=np.asarray(got), aux=float(aux))

# expert parallelism: the reduced qwen3 at capacity 0.5 (drops)
q = B.get_arch("qwen3_moe_30b_a3b").reduced()
q = dataclasses.replace(q, moe=dataclasses.replace(q.moe,
                                                   capacity_factor=0.5))
params = M.init_params(jax.random.PRNGKey(1), q)
toks = np.random.default_rng(1).integers(0, q.vocab, (4, 16)).astype(
    np.int32)
one, one_aux = M.forward_train(params, jnp.asarray(toks), q)
ep = {{"params": host(params), "toks": toks, "logits_1": np.asarray(one),
      "aux_1": float(one_aux)}}
for shape in ((1, 2), (2, 2)):
    with ctx.use_mesh(mesh(shape)):
        assert M._use_ep(q)
        p_sh = put(params, M.param_specs(q))
        t_sh = jax.device_put(jnp.asarray(toks),
                              ctx.named_sharding(('dp', None)))
        got, aux = jax.jit(lambda p, t: M.forward_train(p, t, q))(p_sh, t_sh)
    ep[shape] = (np.asarray(got), float(aux))
out["ep"] = ep

# EP training on (2, 2), AdamW: the losses as reported (device 0's), the
# final parameters, and each dp row's aux at every step's parameters (its
# rows alone, unsharded: the local capacity)
ocfg = OptConfig(name="adamw", total_steps={steps})
dq = DataConfig(vocab=q.vocab, seq_len=16, global_batch=4, seed=1)
with ctx.use_mesh(mesh((2, 2))):
    pspecs = ST.resolve_tree(M.param_specs(q))
    ospecs = ST.resolve_tree(opt_state_specs(M.param_specs(q), ocfg))
    p_sh = jax.device_put(params, pspecs)
    opt = jax.device_put(init_opt_state(params, ocfg), ospecs)
    bspecs = ST.resolve_tree(ST.batch_specs(
        q, B.ShapeConfig("t", 16, 4, "train")))
    step = jax.jit(ST.make_train_step(q, ocfg),
                   in_shardings=(pspecs, ospecs, bspecs, None),
                   out_shardings=(pspecs, ospecs, None))
    losses, befores, batches = [], [], []
    for s in range({steps}):
        b = {{k: jnp.asarray(v) for k, v in synth_batch(dq, s).items()}}
        befores.append(host(p_sh))
        batches.append(np.asarray(b["tokens"]))
        p_sh, opt, met = step(p_sh, opt, b, jnp.int32(s))
        losses.append(float(met["loss"]))
row_aux = [[float(M.forward_train(pb, jnp.asarray(t[r:r + 2]), q)[1])
            for r in (0, 2)] for pb, t in zip(befores, batches)]
out["ep_train"] = dict(losses=losses, params=host(p_sh), row_aux=row_aux)

# the sequence-split decode: the reduced jamba, batch 1
j = B.get_arch("jamba_1_5_large_398b").reduced()
params = M.init_params(jax.random.PRNGKey(2), j)
rng = np.random.default_rng(2)
prompt = rng.integers(0, j.vocab, (1, 8)).astype(np.int32)
feed = rng.integers(0, j.vocab, ({dec_steps}, 1, 1)).astype(np.int32)
_, cache0 = M.prefill(params, jnp.asarray(prompt), j, max_len=16)
dec = {{"params": host(params), "prompt": prompt, "feed": feed}}
for shape in ((1, 2, 1), (1, 4, 1)):
    with ctx.use_mesh(mesh(shape)):
        p_sh = put(params, M.param_specs(j))
        cache = put(cache0, ST.stacked_cache_specs(j, 1))
        step = jax.jit(lambda p, c, t, pos: M.decode_step(
            p, c, t, pos, j, seq_shard=True))
        logits = []
        for s in range({dec_steps}):
            lg, cache = step(p_sh, cache, jnp.asarray(feed[s]),
                             jnp.asarray([8 + s], jnp.int32))
            logits.append(np.asarray(lg))
    dec[shape] = np.stack(logits)
out["dec"] = dec

# sharded train steps of the reduced llama on (2, 2)
l = B.get_arch("llama3_2_1b").reduced()
params0 = M.init_params(jax.random.PRNGKey(3), l)
dcfg = DataConfig(vocab=l.vocab, seq_len=32, global_batch=8, seed=3)
train = {{"params": host(params0)}}
m22 = mesh((2, 2))
for name in {opts!r}:
    ocfg = OptConfig(name=name, total_steps={steps})
    with ctx.use_mesh(m22):
        pspecs = ST.resolve_tree(M.param_specs(l))
        ospecs = ST.resolve_tree(opt_state_specs(M.param_specs(l), ocfg))
        params = jax.device_put(params0, pspecs)
        opt = jax.device_put(init_opt_state(params0, ocfg), ospecs)
        bspecs = ST.resolve_tree(ST.batch_specs(
            l, B.ShapeConfig("t", 32, 8, "train")))
        step = jax.jit(ST.make_train_step(l, ocfg),
                       in_shardings=(pspecs, ospecs, bspecs, None),
                       out_shardings=(pspecs, ospecs, None))
        losses = []
        for s in range({steps}):
            b = {{k: jnp.asarray(v) for k, v in synth_batch(dcfg, s).items()}}
            params, opt, met = step(params, opt, b, jnp.int32(s))
            losses.append(float(met["loss"]))
    train[name] = dict(losses=losses, params=host(params), opt=host(opt))
    if name == "adamw":
        store.save_checkpoint(CKPT, {steps}, {{"params": params, "opt": opt}},
                              metadata={{"from": "reference (2, 2)"}})
        # each leaf's shard shape and every device's block on (2, 2)
        rest = {{}}
        for tag, tree, specs in (("params", params, pspecs),
                                 ("opt", opt, ospecs)):
            shs = jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, NamedSharding))
            rest[tag] = [
                (sh.shard_shape(x.shape),
                 [tuple((s.start or 0, n if s.stop is None else s.stop)
                        for s, n in zip(sh.devices_indices_map(x.shape)[d],
                                        x.shape))
                  for d in m22.devices.flat])
                for x, sh in zip(jax.tree.leaves(tree), shs)]
        train["rest"] = rest
out["train"] = train
with open(OUT, "wb") as f:
    pickle.dump(out, f)
print("REF-OK")
'''

# the reference restores the port's checkpoint onto (2, 2)
RESTORE_SCRIPT = r'''
import pickle
import numpy as np
import jax
from jax.sharding import AxisType
from repro.configs import base as B
from repro.models import model as M
from repro.parallel import ctx
from repro.launch import steps as ST
from repro.optim import OptConfig, init_opt_state, opt_state_specs
from repro.checkpoint import store

l = B.get_arch("llama3_2_1b").reduced()
ocfg = OptConfig(name="adamw", total_steps={steps})
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:4])
params = M.init_params(jax.random.PRNGKey(9), l)
tmpl = {{"params": params, "opt": init_opt_state(params, ocfg)}}
with ctx.use_mesh(mesh):
    shardings = {{"params": ST.resolve_tree(M.param_specs(l)),
                  "opt": ST.resolve_tree(opt_state_specs(M.param_specs(l),
                                                         ocfg))}}
    tree, meta = store.load_checkpoint({ckpt!r}, {steps}, tmpl, shardings)
with open({want!r}, "rb") as f:
    want = pickle.load(f)
got = jax.tree.leaves(tree)
assert len(got) == len(want)
for g, w, s in zip(got, want, jax.tree.leaves(shardings)):
    assert g.sharding == s
    for shard in g.addressable_shards:
        assert np.array_equal(np.asarray(shard.data), w[shard.index])
print("RESTORE-OK", meta)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("ref")
    out, ckpt = str(d / "out.pkl"), str(d / "ckpt")
    text = run_subprocess(REF_SCRIPT.format(
        out=out, ckpt=ckpt, opts=OPTS, steps=TRAIN_STEPS,
        dec_steps=DEC_STEPS), devices=8)
    assert "REF-OK" in text, text
    with open(out, "rb") as f:
        res = pickle.load(f)
    res["ckpt"] = ckpt
    return res


def _ranks(fn, world, tmp_path, *args):
    from repro_torch.parallel.spawn import run_ranks
    return run_ranks(fn, world, *args, timeout_s=420.0,
                     workdir=str(tmp_path))


# ---------------------------------------------------------------------------
# configurations, on both sides
# ---------------------------------------------------------------------------

def _hybrid():
    from repro_torch.configs.base import (LayerSpec, MoEConfig, ModelConfig,
                                          SSMConfig)
    return ModelConfig(name='hyb', n_layers=4, d_model=64, n_heads=4,
                       n_kv_heads=2, d_ff=128, vocab=256,
                       period=(LayerSpec(kind='ssm'),
                               LayerSpec(kind='attn', moe=True)),
                       ssm=SSMConfig(d_state=16, headdim=16, chunk=8),
                       moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                                     capacity_factor=2.0), remat=True)


def _qwen():
    from repro_torch.configs import base as B
    q = B.get_arch("qwen3_moe_30b_a3b").reduced()
    return dataclasses.replace(q, moe=dataclasses.replace(
        q.moe, capacity_factor=0.5))


def _arch(name):
    from repro_torch.configs import base as B
    return B.get_arch(name).reduced()


def _tokens(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.int64)


def _mesh(shape):
    from repro_torch.launch import mesh as meshes
    if len(shape) == 3:
        return meshes.make_debug_mesh(shape[1], shape[2], pods=shape[0],
                                      device="cpu")
    return meshes.make_debug_mesh(*shape, device="cpu")


# ---------------------------------------------------------------------------
# 8 ranks: the reference test's hybrid model on (2, 2, 2)
# ---------------------------------------------------------------------------

def _hybrid_rank(rank, world, hyb):
    from repro_torch import convert as C
    from repro_torch.models import model as M
    from repro_torch.parallel import ctx
    cfg = _hybrid()
    with ctx.use_mesh(_mesh((2, 2, 2))):
        params = C.model_params(hyb["params"], cfg, "cpu")
        local = {n: tuple(p.shape) for n, p in params.named_parameters()}
        logits, aux = M.forward_train(params, _tokens(hyb["toks"]), cfg)
    return logits.detach().numpy(), float(aux), local


def test_hybrid_model_on_eight_ranks(ref, tmp_path):
    """The reference test's SSM + MoE model (remat, EP over "model") on a
    (2, 2, 2) mesh: every rank's logits within 1e-3 of the reference's
    sharded forward, as the reference test holds its own; and within the
    float32 tolerance of the port's unsharded forward."""
    from repro_torch import convert as C
    from repro_torch.models import model as M
    hyb = ref["hyb"]
    cfg = _hybrid()
    whole, _ = M.forward_train(C.model_params(hyb["params"], cfg, "cpu"),
                               _tokens(hyb["toks"]), cfg)
    outs = _ranks(_hybrid_rank, 8, tmp_path, hyb)
    for logits, aux, local in outs:
        assert np.abs(logits - hyb["logits"]).max() < HYB_ATOL
        np.testing.assert_allclose(logits, whole.detach().numpy(),
                                   rtol=RTOL, atol=ATOL)
    # at rest: the experts split over model, d_model over fsdp (pod, data)
    assert outs[0][2]["layers.1.ffn.w_gate"] == (2, 16, 32)
    assert outs[0][2]["layers.1.mixer.wq"] == (16, 32)


# ---------------------------------------------------------------------------
# 2 ranks: EP on (1, 2), the sequence-split decode on (1, 2, 1), the LUT
# projections on (2, 1), the train CLI under --mesh host
# ---------------------------------------------------------------------------

def _lut():
    return np.random.default_rng(5).integers(0, 65536, (256, 256))


def _two_rank(rank, world, ep, dec, cli_dir):
    from repro_torch import convert as C
    from repro_torch.launch import train as TR
    from repro_torch.models import model as M
    from repro_torch.models import quant
    from repro_torch.parallel import ctx
    out = {}
    q = _qwen()
    with ctx.use_mesh(_mesh((1, 2))):
        params = C.model_params(ep["params"], q, "cpu")
        lg, aux = M.forward_train(params, _tokens(ep["toks"]), q)
        out["ep"] = (lg.detach().numpy(), float(aux))
    out["dec"] = _seq_decode(dec, (1, 2, 1))
    # the approximate multiplier on a dp-split batch, against unsharded:
    # a projection bit for bit (and not with this rank's own scale), the
    # model within float32 rounding
    cfg = dataclasses.replace(_arch("llama3_2_1b"), approx_matmul=True)
    quant.set_multiplier_lut(_lut())
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal((4, 12, 64)) * np.arange(
        1, 5)[:, None, None], dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((64, 96)), dtype=torch.float32)
    toks = _tokens(rng.integers(0, cfg.vocab, (4, 12)))
    whole = M.init_params(torch.Generator().manual_seed(6), cfg)
    runs = {}
    for shape in (None, (2, 1)):
        with ctx.use_mesh(_mesh(shape) if shape else None):
            rows = slice(2 * rank, 2 * rank + 2) if shape else slice(None)
            with ctx.split_batch(shape is not None):
                proj = quant.approx_matmul(x[rows], w)
            own = quant.approx_matmul(x[rows], w)
            params = C.model_params(C.reference_params(whole, cfg), cfg,
                                    "cpu")
            fw, _ = M.forward_train(params, toks, cfg)
            pre, cache = M.prefill(params, toks, cfg, max_len=16)
            d, _ = M.decode_step(params, cache, toks[:, :1],
                                 torch.full((4,), 12), cfg)
            runs[shape] = [t.numpy() for t in (proj, own, fw, pre, d)]
    quant.set_multiplier_lut(None)
    out["lut"] = runs
    # the CLI under --mesh host, and the production meshes' raises
    TR.main(["--arch", "llama3_2_1b", "--reduced", "--mesh", "host",
             "--steps", "2", "--batch", "4", "--seq", "16", "--device",
             "cpu", "--ckpt-dir", cli_dir, "--ckpt-every", "1"])
    for name in ("single", "multi"):
        try:
            TR.train("llama3_2_1b", steps=1, mesh_name=name, device="cpu")
        except ValueError as e:
            out[name] = str(e)
    return out


def _seq_decode(dec, shape):
    """The port's sequence-split decode of the reduced jamba on ``shape``
    (the prompt's prefill unsharded, its cache then placed)."""
    from repro_torch import convert as C
    from repro_torch.models import model as M
    from repro_torch.parallel import ctx
    j = _arch("jamba_1_5_large_398b")
    params = C.model_params(dec["params"], j, "cpu")
    _, cache = M.prefill(params, _tokens(dec["prompt"]), j, max_len=16)
    tree = C.reference_cache(cache, j)
    logits, local = [], None
    with ctx.use_mesh(_mesh(shape)):
        params = C.model_params(dec["params"], j, "cpu")
        cache = C.cache(tree, j, "cpu")
        local = tuple(cache[3]["k"].shape)
        for s in range(DEC_STEPS):
            lg, cache = M.decode_step(params, cache, _tokens(dec["feed"][s]),
                                      torch.tensor([8 + s]), j,
                                      seq_shard=True)
            logits.append(lg.numpy())
    return np.stack(logits), local


def test_two_ranks(ref, tmp_path):
    """On 2 ranks: EP on (1, 2) equals the reference's EP; the sequence-
    split decode equals the reference's and the port's unsharded decode;
    on a (2, 1) dp split the approximate multiplier's projection equals
    the unsharded rows bit for bit (with the rank's own scale it does not)
    and the model's forward, prefill and decode the unsharded ones within
    float32 rounding (their float products see another batch size); ``--mesh host`` trains
    and checkpoints; ``single`` / ``multi`` raise as ``jax.make_mesh``
    does for a device count that does not fit."""
    cli = str(tmp_path / "cli")
    outs = _ranks(_two_rank, 2, tmp_path, ref["ep"], ref["dec"], cli)
    ep_want, aux_want = ref["ep"][(1, 2)]
    for out in outs:
        np.testing.assert_allclose(out["ep"][0], ep_want, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(out["ep"][1], aux_want, rtol=RTOL)
        logits, local = out["dec"]
        assert local == (1, 8, 2, 16)          # 16 rows over 2 dp ranks
        np.testing.assert_allclose(logits, ref["dec"][(1, 2, 1)],
                                   rtol=RTOL, atol=ATOL)
    for rank, out in enumerate(outs):
        whole, split = out["lut"][None], out["lut"][(2, 1)]
        rows = slice(2 * rank, 2 * rank + 2)
        assert np.array_equal(split[0], whole[0][rows])
        if rank == 0:     # rank 1 holds the rows that set the range
            assert not np.array_equal(split[1], whole[0][rows])
        for a, b in zip(split[2:], whole[2:]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        assert "needs 256 ranks, the world has 2" in out["single"]
        assert "needs 512 ranks, the world has 2" in out["multi"]
    np.testing.assert_allclose(outs[0]["dec"][0], _unsharded_decode(ref),
                               rtol=RTOL, atol=ATOL)
    from repro_torch.checkpoint import store
    assert store.latest_step(cli) == 2


def _unsharded_decode(ref):
    from repro_torch import convert as C
    from repro_torch.models import model as M
    dec = ref["dec"]
    j = _arch("jamba_1_5_large_398b")
    params = C.model_params(dec["params"], j, "cpu")
    _, cache = M.prefill(params, _tokens(dec["prompt"]), j, max_len=16)
    out = []
    for s in range(DEC_STEPS):
        lg, cache = M.decode_step(params, cache, _tokens(dec["feed"][s]),
                                  torch.tensor([8 + s]), j)
        out.append(lg.numpy())
    return np.stack(out)


def test_one_rank_world_and_mesh_raises():
    """Alone (no torchrun environment) ``--mesh host`` is a one-rank world,
    destroyed after; ``single`` raises there."""
    import torch.distributed as dist
    from repro_torch.launch import train as TR
    out = TR.train("llama3_2_1b", steps=2, batch=2, seq=16,
                   mesh_name="host", device="cpu")
    whole = TR.train("llama3_2_1b", steps=2, batch=2, seq=16, device="cpu")
    np.testing.assert_allclose(out["losses"], whole["losses"],
                               rtol=LOSS_RTOL)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="needs 256 ranks, the world has 1"):
        TR.train("llama3_2_1b", steps=1, mesh_name="single", device="cpu")


# ---------------------------------------------------------------------------
# 4 ranks: EP on (2, 2), train steps, the optimizer on slices, the layout
# at rest, elastic restores, the sequence-split decode on (1, 4, 1), the
# collectives over axis tuples
# ---------------------------------------------------------------------------

def _train_run(train, opt, steps=TRAIN_STEPS, cfg=None, data=(32, 8, 3)):
    """The port's train steps of ``cfg`` (the reduced llama) on the active
    mesh (or none) from the reference's initial parameters, on the
    batches of ``data`` = (seq, batch, seed): (losses, whole params, whole
    state)."""
    from repro_torch import convert as C
    from repro_torch import tree as T
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, init_opt_state, opt_state_specs
    from repro_torch.parallel import ctx
    cfg = cfg or _arch("llama3_2_1b")
    ocfg = OptConfig(name=opt, total_steps=TRAIN_STEPS)
    params = C.model_params(train["params"], cfg, "cpu")
    state = init_opt_state(C.reference_tree(params, cfg), ocfg)
    step = ST.make_train_step(cfg, ocfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=data[0], global_batch=data[1],
                      seed=data[2])
    losses = []
    for s in range(steps):
        b = {k: _tokens(v) for k, v in synth_batch(dcfg, s).items()}
        params, state, met = step(params, state, b, s)
        losses.append(float(met["loss"]))
    if ctx.get_mesh() is not None:
        state = store.gather_to_host(state, ST.resolve_tree(
            opt_state_specs(M.param_specs(cfg), ocfg)), True)
    else:
        state = T.map(store.to_host, state)
    return losses, C.reference_params(params, cfg), state


def _restore(ckpt, step, mesh):
    """(the checkpoint restored onto ``mesh``: this rank's leaves, in leaf
    order; the tree's shardings' leaves)."""
    from repro_torch import convert as C
    from repro_torch import tree as T
    from repro_torch.checkpoint import store
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, init_opt_state, opt_state_specs
    from repro_torch.parallel import ctx
    cfg = _arch("llama3_2_1b")
    ocfg = OptConfig(name="adamw", total_steps=TRAIN_STEPS)
    with ctx.use_mesh(mesh):
        params = M.init_params(torch.Generator().manual_seed(9), cfg)
        C.shard_params(params, cfg)
        tmpl = {"params": C.reference_tree(params, cfg),
                "opt": init_opt_state(C.reference_tree(params, cfg), ocfg)}
        shardings = {"params": ST.resolve_tree(M.param_specs(cfg)),
                     "opt": ST.resolve_tree(opt_state_specs(
                         M.param_specs(cfg), ocfg))}
        tree, meta = store.load_checkpoint(ckpt, step, tmpl, shardings)
    return tree, shardings, meta


def _optimizer_on_slices(mesh, seed):
    """The optimizers on this rank's slices against the whole update, from
    the same whole gradients (``seed``): AdamW and 8-bit AdamW bit for bit
    at a norm below clip_norm, within RTOL above it; Adafactor within
    float32 rounding (its means over a split dim sum over ranks)."""
    from repro_torch import convert as C
    from repro_torch import tree as T
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.optim import (OptConfig, apply_gradients, global_norm,
                                   init_opt_state, opt_state_specs)
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import ctx
    cfg = _arch("llama3_2_1b")
    whole = C.reference_tree(M.init_params(
        torch.Generator().manual_seed(seed), cfg), cfg)
    rng = np.random.default_rng(seed)
    out = {}
    for scale in (1e-4, 1.0):
        grads = T.map(lambda p: torch.as_tensor(
            rng.standard_normal(p.shape) * scale, dtype=torch.float32),
            whole)
        with ctx.use_mesh(mesh):
            shs = ST.resolve_tree(M.param_specs(cfg))
            place = lambda t: T.map(coll.place, t, shs)
            out[("norm", scale)] = (float(global_norm(grads)),
                                    float(global_norm(place(grads), shs)))
            for name in OPTS:
                ocfg = OptConfig(name=name, warmup_steps=1)
                state = init_opt_state(whole, ocfg)
                want_p, want_s = apply_gradients(whole, grads, state, 0,
                                                 ocfg)
                want_p, want_s = apply_gradients(want_p, grads, want_s, 1,
                                                 ocfg)
                oshs = ST.resolve_tree(opt_state_specs(M.param_specs(cfg),
                                                       ocfg))
                got_p, got_s = apply_gradients(
                    place(whole), place(grads),
                    T.map(coll.place, state, oshs), 0, ocfg, shs)
                got_p, got_s = apply_gradients(got_p, place(grads), got_s,
                                               1, ocfg, shs)
                out[(name, scale)] = [
                    (a.numpy(), coll.place(b, s).numpy())
                    for a, b, s in zip(
                        T.leaves(got_p) + T.leaves(got_s),
                        T.leaves(want_p) + T.leaves(want_s),
                        T.leaves(shs) + T.leaves(oshs))]
    return out


def _four_rank(rank, world, ep, train, dec, ref_ckpt, port_ckpt):
    import torch.distributed as dist
    from repro_torch import convert as C
    from repro_torch import tree as T
    from repro_torch.checkpoint import store
    from repro_torch.models import model as M
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import ctx
    out = {}
    m22, m41 = _mesh((2, 2)), _mesh((1, 4, 1))
    q = _qwen()
    with ctx.use_mesh(m22):
        params = C.model_params(ep["params"], q, "cpu")
        lg, aux = M.forward_train(params, _tokens(ep["toks"]), q)
        out["ep"] = (lg.detach().numpy(), float(aux))
        out["ep_train"] = _train_run(ep, "adamw", cfg=q, data=(16, 4, 1))
        for opt in OPTS:
            out[opt] = _train_run(train, opt)
        # at rest: the reference's initial parameters placed on (2, 2)
        cfg = _arch("llama3_2_1b")
        params = C.model_params(train["params"], cfg, "cpu")
        out["rest_params"] = [t.numpy() for t in T.leaves(
            C.reference_tree(params, cfg))]
    out["opt"] = _optimizer_on_slices(m22, 4)
    # elastic restores: the reference's (2, 2) checkpoint onto (4, 1) and
    # (2, 2); the port's own from (2, 2) onto (1, 4, 1) and back
    for tag, mesh in (("r41", m41), ("r22", m22)):
        tree, _, meta = _restore(ref_ckpt, TRAIN_STEPS, mesh)
        out[tag] = ([t.numpy() for t in T.leaves(tree)], meta)
    tree, shs, _ = _restore(ref_ckpt, TRAIN_STEPS, m22)
    whole = store.gather_to_host(tree, shs, rank == 0)
    if rank == 0:
        store.save_checkpoint(port_ckpt, TRAIN_STEPS, whole,
                              metadata={"from": "port (2, 2)"})
    dist.barrier()
    tree, shs, meta = _restore(port_ckpt, TRAIN_STEPS, m41)
    out["p41"] = ([t.numpy() for t in T.leaves(tree)], meta)
    whole = store.gather_to_host(tree, shs, rank == 0)
    if rank == 0:
        store.save_checkpoint(port_ckpt, TRAIN_STEPS + 1, whole,
                              metadata={"from": "port (1, 4, 1)"})
    out["dec"] = _seq_decode(dec, (1, 4, 1))
    # gloo's own gather and reduce-scatter over axis tuples: every rank's
    # block in row-major order of the axes, bits (-0.0 included) kept;
    # integer-valued sums, exact in any order
    x = _rank_block(rank)
    got = {}
    for axes in (("data",), ("model",), ("data", "model")):
        y = torch.round(torch.cat([x] * m22.size(axes), 0) * 64)
        got[axes] = (coll.all_gather_raw(x, m22, axes, 1).numpy(),
                      coll.reduce_scatter_raw(y, m22, axes, 0).numpy())
    out["collectives"] = got
    return out


def _rank_block(rank):
    x = torch.as_tensor(np.random.default_rng(rank).standard_normal(
        (3, 5)), dtype=torch.float32)
    x[0, 0] = -0.0
    return x


def _block(arr, index):
    return arr[tuple(slice(a, b) for a, b in index)]


def test_four_ranks(ref, tmp_path):
    """On 4 ranks: EP on (2, 2) equals the reference's (whose token block
    is split over dp, with a capacity of the local rows: not the unsharded
    function), and EP training follows the reference's, its losses apart
    only by the aux's rule (fact 3); sharded train steps of all three
    optimizers equal the reference's sharded run and the port's unsharded
    run; the layout at rest is ``NamedSharding``'s; the optimizer on slices equals the whole
    one; checkpoints restore across meshes and packages; the sequence-
    split decode on 4 ranks; gloo's gather and reduce-scatter over axis
    tuples."""
    from repro_torch import tree as T
    port_ckpt = str(tmp_path / "port_ckpt")
    outs = _ranks(_four_rank, 4, tmp_path, ref["ep"], ref["train"],
                  ref["dec"], ref["ckpt"], port_ckpt)
    train = ref["train"]
    # EP (2, 2): the reference's EP, and (fact 2) not the unsharded MoE
    ep_want, aux_want = ref["ep"][(2, 2)]
    for out in outs:
        np.testing.assert_allclose(out["ep"][0], ep_want, rtol=RTOL,
                                   atol=ATOL)
    assert np.abs(ep_want - ref["ep"]["logits_1"]).max() > 100 * ATOL
    # EP training on (2, 2) (fact 3): both packages differentiate the dp
    # rows' mean aux, so the parameters follow the reference's; the
    # reference reports device 0's loss, whose aux is its first dp row's,
    # the port the mean's: port = reference + 0.01 · (mean − row 0), each
    # row's aux the reference's
    ept = ref["ep_train"]
    rows = np.array(ept["row_aux"])
    shift = 0.01 * (rows.mean(1) - rows[:, 0])
    assert np.abs(shift).min() > 10 * LOSS_RTOL * max(ept["losses"])
    for out in outs:
        losses, params, _ = out["ep_train"]
        np.testing.assert_allclose(losses, np.array(ept["losses"]) + shift,
                                   rtol=LOSS_RTOL)
        for a, b in zip(T.leaves(params), T.leaves(ept["params"])):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    wholes = {}
    for opt in OPTS:
        wholes[opt] = _train_run(train, opt)
    for out in outs:
        for opt in OPTS:
            losses, params, state = out[opt]
            np.testing.assert_allclose(losses, train[opt]["losses"],
                                       rtol=LOSS_RTOL)
            np.testing.assert_allclose(losses, wholes[opt][0],
                                       rtol=LOSS_RTOL)
            for a, b in zip(T.leaves(params), T.leaves(wholes[opt][1])):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
            for a, b in zip(T.leaves(state), T.leaves(wholes[opt][2])):
                if a.dtype == np.int8:       # one quantization step
                    assert np.abs(a.astype(int) - b).max() <= 1
                else:
                    np.testing.assert_allclose(a, b, rtol=RTOL,
                                               atol=ATOL)
    # at rest and restored: every leaf is NamedSharding's block
    rest = train["rest"]
    init = [np.asarray(x) for x in T.leaves(train["params"])]
    # a checkpoint's leaves: {"opt", "params"} in sorted key order
    saved = [np.asarray(x) for x in T.leaves(
        {"params": train["adamw"]["params"], "opt": train["adamw"]["opt"]})]
    for r, out in enumerate(outs):
        for x, w, (shape, idx) in zip(out["rest_params"], init,
                                      rest["params"]):
            assert x.shape == tuple(shape)
            assert np.array_equal(x, _block(w, idx[r]))
        got, meta = out["r22"]
        for x, w, (shape, idx) in zip(got, saved,
                                      rest["opt"] + rest["params"]):
            assert x.shape == tuple(shape)
            assert np.array_equal(x, _block(w, idx[r]))
        for tag in ("r41", "p41"):
            got, meta = out[tag]
            for x, w in zip(got, saved):
                # (1, 4, 1): fsdp over 4 data ranks, "tp" whole
                assert np.array_equal(x, _own_block(w, x.shape, r))
        assert out["p41"][1] == {"from": "port (2, 2)"}
        # the optimizer on slices
        opt = out["opt"]
        for scale in (1e-4, 1.0):
            a, b = opt[("norm", scale)]
            np.testing.assert_allclose(a, b, rtol=1e-6)
            for name in OPTS:
                for got, want in opt[(name, scale)]:
                    if name != "adafactor" and scale < 1:
                        assert np.array_equal(got, want), name
                    elif got.dtype == np.int8:
                        assert np.abs(got.astype(int) - want).max() <= 1
                    else:
                        # float32 rounding of the leaf's largest value;
                        # under 8-bit moments an element whose moment
                        # flips one quantization step at a rounding tie
                        # (the clip scale differs in its last bits)
                        far = ~np.isclose(got, want, rtol=1e-6,
                                          atol=1e-6 * np.abs(want).max())
                        assert far.mean() <= (
                            Q_FLIP_FRACTION if name == "adamw8bit" else 0
                        ), (name, scale, got.shape, far.sum())
        np.testing.assert_allclose(out["dec"][0], ref["dec"][(1, 4, 1)],
                                   rtol=RTOL, atol=ATOL)
        assert out["dec"][1] == (1, 4, 2, 16)
        coords = np.argwhere(np.arange(4).reshape(2, 2) == r)[0]
        for axes, (gathered, rs) in out["collectives"].items():
            # the ranks along ``axes`` through this rank, row-major
            peers = [p for p in range(4) if all(
                np.argwhere(np.arange(4).reshape(2, 2) == p)[0][i]
                == coords[i] for i, a in enumerate(("data", "model"))
                if a not in axes)]
            want = np.concatenate([_rank_block(p).numpy() for p in peers],
                                  1)
            assert np.array_equal(gathered.view(np.int32),
                                  want.view(np.int32))
            total = sum(np.round(np.concatenate(
                [_rank_block(p).numpy()] * len(peers), 0) * 64)
                for p in peers)
            i = peers.index(r)
            assert np.array_equal(rs, np.split(total, len(peers))[i])
    # the port's (1, 4, 1) checkpoint restores onto the reference's (2, 2)
    want = str(tmp_path / "want.pkl")
    with open(want, "wb") as f:
        pickle.dump(saved, f)
    text = run_subprocess(RESTORE_SCRIPT.format(
        steps=TRAIN_STEPS + 1, ckpt=port_ckpt, want=want), devices=4)
    assert "RESTORE-OK" in text and "port (1, 4, 1)" in text, text


def _own_block(w, shape, r):
    """Rank ``r``'s block of ``w`` on (1, 4, 1): the first dim split 4 ways
    where the local shape says so."""
    if shape == w.shape:
        return w
    d = next(i for i, (a, b) in enumerate(zip(shape, w.shape)) if a != b)
    n = w.shape[d] // shape[d]
    return np.split(w, n, axis=d)[r]


@pytest.mark.parametrize("arch", ["llama3_2_1b", "jamba_1_5_large_398b"])
def test_one_shard_split_decode_is_the_decode(arch):
    """``decode_self_attention(seq_axes=())``, the sequence-split path's
    arithmetic on one shard (q and the softmax weights float32, no
    collective), equals the ordinary decode (which rounds them to the
    cache's dtype, a no-op in float32) within the float32 tolerance, and
    writes the same caches."""
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    cfg = _arch(arch)
    params = M.init_params(torch.Generator().manual_seed(3), cfg)
    layer = next(lp.mixer for i, lp in enumerate(params.layers)
                 if M.layer_spec(cfg, i).kind == "attn")
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((2, 1, cfg.d_model), generator=gen)
    k, v = (torch.randn((2, 16, cfg.n_kv_heads, cfg.hd), generator=gen)
            for _ in range(2))
    pos = torch.tensor([5, 11])
    with torch.no_grad():
        want = A.decode_self_attention(layer, x, k.clone(), v.clone(), pos,
                                       cfg)
        got = A.decode_self_attention(layer, x, k.clone(), v.clone(), pos,
                                      cfg, seq_axes=())
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)
