"""Tensor-parallel compute of the port's LM over the mesh's "model" axis,
on gloo CPU ranks (``parallel.spawn.run_ranks``), against the JAX
package's sharded runs on forced host devices and the port's unsharded
runs.

Each "model" rank computes its query heads, MLP columns and vocabulary
(``parallel.ctx``'s docstring); the reference's GSPMD partitions the same
matmuls by the same specs.  The reduced llama has 8 query heads and 2 kv
heads: at tp = 2 the kv heads split too (a heads-split cache), at tp = 4
a rank's two query heads share one kv head (an hd-split cache).  The
reduced phi4-mini's 6 heads split as head groups at tp = 4
(``tests/test_torch_tensor_parallel_heads.py`` holds that path against
the reference).

The reference runs once, in a subprocess with 8 host devices, on meshes
with ``Auto`` axis types (as ``tests/test_torch_parallel_lm.py``'s).
Tolerances are that file's: RTOL / ATOL (float32) for logits, gradients
and parameters, LOSS_RTOL for losses.  Exact where both sides are: the
approximate multiplier's logits on a "model" split are one rank's bit for
bit (its ranges are the whole tensors' and its int32 sums are summed
before the float conversion), and a dense layer's matmul FLOPs on a tp
rank are one rank's divided by tp.
"""
import dataclasses
import pickle

import numpy as np
import pytest
import torch

from conftest import run_subprocess

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
LOSS_RTOL = 1e-6
TRAIN_STEPS = 3
DEC_STEPS = 3
FW_SHAPES = ((1, 2), (1, 4), (2, 2))
TRAIN_SHAPES = ((1, 2), (2, 2))

REF_SCRIPT = r'''
import pickle
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import base as B
from repro.models import model as M
from repro.parallel import ctx
from repro.launch import steps as ST
from repro.optim import OptConfig, init_opt_state, opt_state_specs
from repro.data.pipeline import DataConfig, synth_batch

host = lambda t: jax.tree.map(np.asarray, t)

def mesh(shape):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])

l = B.get_arch("llama3_2_1b").reduced()
params0 = M.init_params(jax.random.PRNGKey(3), l)
toks = np.random.default_rng(3).integers(0, l.vocab, (4, 12)).astype(
    np.int32)
out = {{"params": host(params0), "toks": toks, "fw": {{}}, "train": {{}}}}
for shape in {fw_shapes!r}:
    with ctx.use_mesh(mesh(shape)):
        p_sh = jax.device_put(params0, ST.resolve_tree(M.param_specs(l)))
        t_sh = jax.device_put(jnp.asarray(toks),
                              ctx.named_sharding(("dp", None)))
        got, _ = jax.jit(lambda p, t: M.forward_train(p, t, l))(p_sh, t_sh)
    out["fw"][shape] = np.asarray(got)
ocfg = OptConfig(name="adamw", total_steps={steps})
dcfg = DataConfig(vocab=l.vocab, seq_len=32, global_batch=8, seed=3)
for shape in {train_shapes!r}:
    with ctx.use_mesh(mesh(shape)):
        pspecs = ST.resolve_tree(M.param_specs(l))
        ospecs = ST.resolve_tree(opt_state_specs(M.param_specs(l), ocfg))
        params = jax.device_put(params0, pspecs)
        opt = jax.device_put(init_opt_state(params0, ocfg), ospecs)
        bspecs = ST.resolve_tree(ST.batch_specs(
            l, B.ShapeConfig("t", 32, 8, "train")))
        b0 = jax.device_put({{k: jnp.asarray(v) for k, v in
                              synth_batch(dcfg, 0).items()}}, bspecs)
        grads = jax.jit(jax.grad(lambda p, b: M.lm_loss(
            p, b["tokens"], b["targets"], l)))(params, b0)
        step = jax.jit(ST.make_train_step(l, ocfg),
                       in_shardings=(pspecs, ospecs, bspecs, None),
                       out_shardings=(pspecs, ospecs, None))
        losses = []
        for s in range({steps}):
            b = {{k: jnp.asarray(v) for k, v in synth_batch(dcfg, s).items()}}
            params, opt, met = step(params, opt, b, jnp.int32(s))
            losses.append(float(met["loss"]))
    out["train"][shape] = dict(losses=losses, params=host(params),
                               grads=host(grads))
with open({out_file!r}, "wb") as f:
    pickle.dump(out, f)
print("REF-OK")
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_ref") / "out.pkl")
    text = run_subprocess(REF_SCRIPT.format(
        fw_shapes=FW_SHAPES, train_shapes=TRAIN_SHAPES, steps=TRAIN_STEPS,
        out_file=out), devices=8)
    assert "REF-OK" in text, text
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """The port's runs: (the unsharded run, the 2-rank world's results by
    rank, the 4-rank world's)."""
    from repro_torch.parallel.spawn import run_ranks
    d = str(tmp_path_factory.mktemp("tp_ranks"))
    two = run_ranks(_world, 2, ref, timeout_s=420.0, workdir=d)
    four = run_ranks(_world, 4, ref, timeout_s=420.0, workdir=d)
    return _world(0, 1, ref), two, four


# ---------------------------------------------------------------------------
# configurations and runs, the same on every world
# ---------------------------------------------------------------------------

def _arch(name, **changes):
    from repro_torch.configs import base as B
    return dataclasses.replace(B.get_arch(name).reduced(), **changes)


def _tokens(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.int64)


def _lut():
    return np.random.default_rng(5).integers(0, 65536, (256, 256))


def _mesh(shape):
    from repro_torch.launch import mesh as meshes
    return None if shape is None else meshes.make_debug_mesh(
        *shape, device="cpu")


def _params(ref, cfg):
    from repro_torch import convert as C
    return C.model_params(ref["params"], cfg, "cpu")


def _seeded(cfg, seed=6):
    """The reduced ``cfg``'s parameters from ``seed``, placed on the
    active mesh."""
    from repro_torch import convert as C
    from repro_torch.models import model as M
    from repro_torch.parallel import ctx
    with ctx.use_mesh(None):
        whole = C.reference_params(M.init_params(
            torch.Generator().manual_seed(seed), cfg), cfg)
    return C.model_params(whole, cfg, "cpu")


def _serve(params, cfg, toks):
    """(forward logits, prefill logits, DEC_STEPS decode steps' logits,
    the first layer's cache at rest, the k cache the first layer's decode
    computes on)."""
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    real, seen = A.decode_self_attention, []

    def rec(params_, x, k, *a, **kw):
        seen.append(tuple(k.shape))
        return real(params_, x, k, *a, **kw)
    A.decode_self_attention = rec
    try:
        with torch.no_grad():
            fw, _ = M.forward_train(params, toks, cfg)
            pre, cache = M.prefill(params, toks, cfg,
                                   max_len=toks.shape[1] + DEC_STEPS)
            steps = []
            for s in range(DEC_STEPS):
                lg, cache = M.decode_step(
                    params, cache, toks[:, s:s + 1],
                    torch.full((toks.shape[0],), toks.shape[1] + s), cfg)
                steps.append(lg)
    finally:
        A.decode_self_attention = real
    return ([t.numpy() for t in (fw, pre, torch.stack(steps))],
            tuple(cache[0]["k"].shape), seen[0])


def _grads_and_train(ref, cfg):
    """(the gradients of step 0's loss, whole; TRAIN_STEPS AdamW steps:
    losses, whole parameters; the clip's global norm of step 0's
    gradients, from this rank's slices) from the reference's initial
    parameters on the reference test's batches."""
    from repro_torch import convert as C
    from repro_torch import tree as T
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, global_norm, init_opt_state
    from repro_torch.parallel import ctx
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=3)
    batches = [{k: _tokens(v) for k, v in synth_batch(dcfg, s).items()}
               for s in range(TRAIN_STEPS)]
    params = _params(ref, cfg)
    _, grads = ST.loss_and_grads(params, cfg, batches[0]["tokens"],
                                 batches[0]["targets"])
    shardings = (ST.resolve_tree(M.param_specs(cfg))
                 if ctx.get_mesh() is not None else None)
    norm = float(global_norm(grads, shardings))
    if shardings is not None:
        grads = store.gather_to_host(grads, shardings, True)
    grads = [store.to_host(g) for g in T.leaves(grads)]
    ocfg = OptConfig(name="adamw", total_steps=TRAIN_STEPS)
    params = _params(ref, cfg)
    state = init_opt_state(C.reference_tree(params, cfg), ocfg)
    step = ST.make_train_step(cfg, ocfg)
    losses = []
    for s, b in enumerate(batches):
        params, state, met = step(params, state, b, s)
        losses.append(float(met["loss"]))
    return grads, losses, [t for t in T.leaves(C.reference_params(
        params, cfg))], norm


def _gathers(fn):
    """(``fn()``, the (axes, input shape, dim) of every all-gather it
    issues)."""
    from repro_torch.parallel import collectives as coll
    real, seen = coll.all_gather_raw, []

    def rec(x, mesh, axes, dim):
        seen.append((coll._axes(mesh, axes), tuple(x.shape), dim))
        return real(x, mesh, axes, dim)
    coll.all_gather_raw = rec
    try:
        return fn(), seen
    finally:
        coll.all_gather_raw = real


def _flops(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _layer_flops(cfg, seed=6):
    """The matmul FLOPs of the first layer's forward (mixer and FFN) on the
    active mesh, from (4, 12) tokens' worth of activations."""
    from repro_torch.models import model as M
    params = _seeded(cfg, seed)
    x = torch.randn((4, 12, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        return _flops(lambda: M._layer(M.layer_spec(cfg, 0),
                                       params.layers[0], x, cfg))


def _blocks(cfg):
    """Each self-attention call's "tp" axes, its head groups × head_dim
    slices (None where it splits by heads or computes whole) and wq's
    shape in the compute, over one forward of ``cfg``: which blocks
    split, and how."""
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    real, seen = A.self_attention, []

    def rec(params, x, cfg_, *a, tp=(), heads=None, **kw):
        seen.append((tp, heads and (heads.axes, heads.groups, heads.slices),
                     tuple(params.wq.shape)))
        return real(params, x, cfg_, *a, tp=tp, heads=heads, **kw)
    A.self_attention = rec
    try:
        with torch.no_grad():
            M.forward_train(_seeded(cfg), _tokens(np.zeros((4, 12))), cfg)
    finally:
        A.self_attention = real
    return seen


def _lut_run(cfg, toks):
    from repro_torch.models import quant
    quant.set_multiplier_lut(_lut())
    try:
        return _serve(_seeded(cfg), cfg, toks)
    finally:
        quant.set_multiplier_lut(None)


def _row_parallel_range(rank):
    """A row-parallel projection on the LUT on (1, 2): (this rank's output
    with the ranges and sums over "tp", the same with the rank's own
    ranges and its float partial summed)."""
    from repro_torch.models import quant
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import ctx
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((24, 64)) * np.repeat(
        [1.0, 4.0], 32), dtype=torch.float32)
    w = torch.as_tensor(rng.standard_normal((64, 48)), dtype=torch.float32)
    cols = slice(32 * rank, 32 * rank + 32)
    quant.set_multiplier_lut(_lut())
    try:
        tp = ctx.tp_axes()
        got = quant.approx_matmul(x[:, cols], w[cols], tp=tp, row=True)
        own = coll.all_reduce_raw(quant.approx_matmul(x[:, cols], w[cols]),
                                  ctx.get_mesh(), tp)
        whole = quant.approx_matmul(x, w)
    finally:
        quant.set_multiplier_lut(None)
    return [t.numpy() for t in (got, own, whole)]


def _world(rank, world, ref):
    """Every run of this world: the unsharded one on a world of 1; (1, 2)
    and (2, 1) on 2 ranks; (1, 4) and (2, 2) on 4."""
    from repro_torch.models import model as M
    from repro_torch.parallel import ctx
    llama = _arch("llama3_2_1b")
    toks = _tokens(ref["toks"])
    shapes = {1: (None,), 2: ((1, 2), (2, 1)), 4: ((1, 4), (2, 2))}[world]
    out = {}
    for shape in shapes:
        r = {}
        with ctx.use_mesh(_mesh(shape)):
            r["lut"] = _lut_run(dataclasses.replace(llama,
                                                    approx_matmul=True), toks)
            if shape == (2, 1):
                out[shape] = r
                continue
            r["fw"] = _serve(_params(ref, llama), llama, toks)
            if shape in ((1, 2), (2, 2), None):
                r["train"] = _grads_and_train(ref, llama)
            if shape in ((1, 2), (1, 4), None):
                r["flops"] = {a: _layer_flops(_arch(a)) for a in (
                    "llama3_2_1b", "stablelm_1_6b", "phi4_mini_3_8b")}
                r["blocks"] = {a: _blocks(_arch(a)) for a in (
                    "llama3_2_1b", "phi4_mini_3_8b")}
                for name, cfg in (
                        ("untied", _arch("stablelm_1_6b",
                                         loss_vocab_chunk=4)),
                        ("tied_chunked", _arch("llama3_2_1b",
                                               loss_vocab_chunk=5)),
                        ("audio", _arch("musicgen_large")),
                        ("phi4", _arch("phi4_mini_3_8b"))):
                    r[name] = _vocab_run(cfg)
            if shape == (1, 2):
                params = _params(ref, llama)
                tgt = _tokens(np.roll(ref["toks"], -1, 1))
                with torch.no_grad():
                    r["loss_flops"] = _flops(lambda: M.lm_loss(
                        params, toks, tgt, llama))
                (_, r["fw_gathers"]) = _gathers(lambda: M.forward_train(
                    params, toks, llama))
                params = _params(ref, llama)
                from repro_torch.launch import steps as ST
                (_, r["train_gathers"]) = _gathers(
                    lambda: ST.loss_and_grads(params, llama, toks, tgt))
                r["range"] = _row_parallel_range(rank)
            if shape is None:
                params = _params(ref, llama)
                tgt = _tokens(np.roll(ref["toks"], -1, 1))
                with torch.no_grad():
                    r["loss_flops"] = _flops(lambda: M.lm_loss(
                        params, toks, tgt, llama))
        out[shape] = r
    return out


def _vocab_run(cfg):
    """(logits of a forward, the loss, its gradients whole) of ``cfg``
    from seeded parameters on (4, 12) seeded tokens (audio (4, 12, C))."""
    from repro_torch import tree as T
    from repro_torch.checkpoint import store
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.parallel import ctx
    rng = np.random.default_rng(8)
    shape = (4, 12) + ((cfg.n_codebooks,) if cfg.frontend == "audio" else ())
    toks = _tokens(rng.integers(0, cfg.vocab, shape))
    tgt = _tokens(rng.integers(0, cfg.vocab, shape))
    params = _seeded(cfg)
    with torch.no_grad():
        fw, _ = M.forward_train(params, toks, cfg)
    loss, grads = ST.loss_and_grads(params, cfg, toks, tgt)
    if ctx.get_mesh() is not None:
        grads = store.gather_to_host(
            grads, ST.resolve_tree(M.param_specs(cfg)), True)
    return (fw.numpy(), float(loss),
            [store.to_host(g) for g in T.leaves(grads)])


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", FW_SHAPES)
def test_forward_against_reference(ref, ranks, shape):
    """The reduced llama's forward, tensor-parallel over "model" (and dp
    over "data" on (2, 2)), on every rank: within the float32 tolerance of
    the reference's sharded forward on the same mesh and of the port's
    unsharded forward; prefill and decode within it of unsharded too."""
    one, two, four = ranks
    outs = two if shape == (1, 2) else four
    whole = one[None]["fw"][0]
    for out in outs:
        got = out[shape]["fw"][0]
        _close(got[0], ref["fw"][shape])
        for a, b in zip(got, whole):
            _close(a, b)


@pytest.mark.parametrize("shape", TRAIN_SHAPES)
def test_training_against_reference(ref, ranks, shape):
    """Step 0's gradients, gathered whole, within the float32 tolerance of
    the reference's sharded gradients and the port's unsharded ones (a
    missing *f* would leave them a tp-th too small), and the clip's norm
    taken on the slices the unsharded one (a norm, replicated over
    "model", counted once); 3 AdamW steps: losses within LOSS_RTOL and
    parameters within the float32 tolerance of both."""
    one, two, four = ranks
    outs = two if shape == (1, 2) else four
    want = ref["train"][shape]
    from repro_torch import tree as T
    ref_grads = [np.asarray(g) for g in T.leaves(want["grads"])]
    ref_params = [np.asarray(p) for p in T.leaves(want["params"])]
    w_grads, w_losses, w_params, w_norm = one[None]["train"]
    for out in outs:
        grads, losses, params, norm = out[shape]["train"]
        np.testing.assert_allclose(norm, w_norm, rtol=LOSS_RTOL)
        for g, r, w in zip(grads, ref_grads, w_grads):
            _close(g, r)
            _close(g, w)
        np.testing.assert_allclose(losses, want["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(losses, w_losses, rtol=LOSS_RTOL)
        for p, r, w in zip(params, ref_params, w_params):
            _close(p, r)
            _close(p, w)


def test_lut_logits_are_one_ranks_bit_for_bit(ranks):
    """On the approximate multiplier a "model" split changes no bit: the
    forward, prefill and decode logits on (1, 2) equal the unsharded
    run's, and on (2, 2) the (2, 1) run's (a dp split alone moves the
    float products' rounding: ``test_torch_parallel_lm.py``); on (1, 4)
    (a shared kv head) the forward and prefill are bit for bit and the
    decode's attention, grouped otherwise, within float32 rounding.  A
    row-parallel projection with the rank's own ranges is not the whole
    one, with the ranges and int32 sums over "tp" it is, bit for bit."""
    one, two, four = ranks
    whole = one[None]["lut"][0]
    dp2 = two[0][(2, 1)]["lut"][0]
    for out in two:
        for a, b in zip(out[(1, 2)]["lut"][0], whole):
            assert np.array_equal(a, b)
        got, own, want = out[(1, 2)]["range"]
        assert np.array_equal(got, want)
        assert not np.array_equal(own, want)
    for out in four:
        for a, b in zip(out[(2, 2)]["lut"][0], dp2):
            assert np.array_equal(a, b)
        fw, pre, dec = out[(1, 4)]["lut"][0]
        assert np.array_equal(fw, whole[0]) and np.array_equal(pre, whole[1])
        _close(dec, whole[2])


def test_decode_on_split_caches(ranks):
    """The decode on a heads-split cache ((1, 2): one of the 2 kv heads a
    rank, as the rank computes them) and on an hd-split one ((1, 4): the
    2 kv heads do not divide over 4, so a rank holds every kv head's
    head_dim slice and attends on it, its partial scores summed over
    "model"): the caches at rest have the reference's shard shapes, and
    the decode computes on the same layout; the logits are unsharded
    within the float32 tolerance."""
    one, two, four = ranks
    want = one[None]["fw"][0]
    for outs, shape, local in ((two, (1, 2), (4, 15, 1, 8)),
                               (four, (1, 4), (4, 15, 2, 2))):
        for out in outs:
            logits, cache, compute = out[shape]["fw"]
            assert cache == compute == local
            for a, b in zip(logits[1:], want[1:]):
                _close(a, b)


@pytest.mark.parametrize("name", ["untied", "tied_chunked", "audio",
                                  "phi4"])
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_vocab_parallel_embedding_and_head(ranks, name, shape):
    """Vocab-parallel embedding and head, tied (the reduced llama, its loss
    in sequence chunks), untied (stablelm-1.6b, chunked), audio (musicgen:
    4 codebooks' tables and heads) and phi4-mini (at tp = 4 its 6 heads
    split as head groups): forward logits, loss and gradients against the
    unsharded run within the float32 tolerance."""
    one, two, four = ranks
    outs = two if shape == (1, 2) else four
    w_fw, w_loss, w_grads = one[None][name]
    for out in outs:
        fw, loss, grads = out[shape][name]
        _close(fw, w_fw)
        np.testing.assert_allclose(loss, w_loss, rtol=LOSS_RTOL)
        for g, w in zip(grads, w_grads):
            _close(g, w)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_a_dense_layers_flops_split_over_tp(ranks, shape):
    """FlopCounterMode on a (1, tp) rank: a dense layer's matmul FLOPs
    (projections and attention) are exactly one rank's over tp where its
    heads and kv heads divide (the reduced llama at tp = 2, stablelm-1.6b
    at 2 and 4) and where its query heads do not (phi4-mini at tp = 4: 2
    head groups × 2 head_dim halves); with a shared kv head (llama at
    tp = 4) the kv projections are the one head's.  The whole loss's
    FLOPs on (1, 2), head included, are half."""
    one, two, four = ranks
    tp = shape[1]
    outs = two if tp == 2 else four
    whole = one[None]["flops"]
    for out in outs:
        got = out[shape]["flops"]
        assert got["stablelm_1_6b"] * tp == whole["stablelm_1_6b"]
        assert got["phi4_mini_3_8b"] * tp == whole["phi4_mini_3_8b"]
        if tp == 2:
            assert got["llama3_2_1b"] * 2 == whole["llama3_2_1b"]
            assert out[shape]["loss_flops"] * 2 == one[None]["loss_flops"]
        else:
            assert whole["llama3_2_1b"] / 4 < got["llama3_2_1b"] < \
                whole["llama3_2_1b"] / 2


def test_blocks_that_do_not_divide_compute_whole(ranks):
    """How self-attention blocks split: the reduced llama's by heads on
    (1, 2) and (1, 4) (wq's columns a rank's); phi4-mini's by heads on
    (1, 2) (6 heads over 2), and on (1, 4), where its 6 heads do not
    divide, as 2 head groups × 2 head_dim halves over "model" (wq's 24
    columns a rank's, as they lie at rest); whole on one rank."""
    one, two, four = ranks
    for outs, shape in ((two, (1, 2)), (four, (1, 4))):
        n = shape[1]
        for out in outs:
            blocks = out[shape]["blocks"]
            assert blocks["llama3_2_1b"] == [
                (("model",), None, (64, 64 // n))] * 2
            want = ((("model",), None, (96, 96 // n)) if n == 2
                    else ((), (("model",), 2, 2), (96, 96 // n)))
            assert blocks["phi4_mini_3_8b"] == [want] * 2
    assert one[None]["blocks"]["phi4_mini_3_8b"] == \
        [((), None, (96, 96))] * 2


def test_no_weight_gather_in_a_dense_block(ranks):
    """On (1, 2) no weight is gathered over "model": the forward's one
    all-gather over it is the logits' (their vocabulary columns), the
    training step's loss (vocab-parallel) and backward issue none."""
    one, two, four = ranks
    for out in two:
        fw = out[(1, 2)]["fw_gathers"]
        assert fw == [(("model",), (4, 12, 256), -1)]
        assert out[(1, 2)]["train_gathers"] == []
