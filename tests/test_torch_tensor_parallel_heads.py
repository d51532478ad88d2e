"""Tensor-parallel compute of the blocks whose dims do not divide over
"model", on gloo CPU ranks (``parallel.spawn.run_ranks``), against the JAX
package's GSPMD runs on forced host devices and the port's one-rank runs.

Query heads that do not divide over n "model" ranks split as the
reference's GSPMD splits them: g = gcd(n_heads, n) head groups, each on
n / g ranks that hold a slice of head_dim; the scores are each rank's
partial sums, all-reduced over its group (``attention.attention_heads``).
The reduced phi4-mini has 6 query heads, 2 kv heads and head_dim 16: on
(1, 4) and (2, 4) that is 2 groups × 2 halves, the groups {0, 1} and
{2, 3} along "model".  A vocabulary that does not divide over "model"
leaves the token table's d_model split there (``embed_specs``): the
embedding looks up the rank's columns and gathers the activations, the
tied head contracts the rank's columns and all-reduces the logits
(``model._embed_cols``): a reduced mamba2 with vocab 250 on (1, 4).

The reference runs once, in a subprocess with 8 host devices on meshes
with ``Auto`` axis types (as ``tests/test_torch_tensor_parallel.py``'s);
the parameters are drawn by the port from a seed and handed to both.
Tolerances are that file's: RTOL / ATOL (float32) for logits, caches,
gradients and parameters, LOSS_RTOL for losses.  Exact: the approximate
multiplier's projections are one rank's bit for bit (on (2, 4) the (2, 1)
run's: a dp split alone moves the float products' rounding), and a rank's
score and p·v FLOPs are one quarter of one rank's.  The approximate
multiplier's logits are not: the scores' partial sums round otherwise
than the whole sum, and that may move a uint8 operand of ``wo`` by a
step, so its tokens are held by ``tests/test_torch_tensor_parallel_hd.
py``'s tie rule.
"""
import dataclasses
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from conftest import run_subprocess

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
LOSS_RTOL = 1e-6
TIE_ATOL = 1e-3
PHI = "phi4_mini_3_8b"
MAMBA = "mamba2_1_3b"
MAMBA_VOCAB = 250          # does not divide over 4
MAMBA_CHUNK = 4            # the loss in sequence chunks, as the full model's
SHAPES = ((1, 4), (2, 4))
TOKS = (4, 12)
DEC_STEPS = 3
MAX_LEN = TOKS[1] + DEC_STEPS
TRAIN_STEPS = 3

REF_SCRIPT = r'''
import pickle, re
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import base as B
from repro.models import model as M
from repro.parallel import ctx
from repro.launch import steps as ST
from repro.optim import OptConfig, init_opt_state, opt_state_specs
from repro.data.pipeline import DataConfig, synth_batch
import dataclasses

host = lambda t: jax.tree.map(np.asarray, t)
with open({data_file!r}, "rb") as f:
    data = pickle.load(f)

def mesh(shape):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])

def score_groups(text, shape):
    """The replica groups of every all-reduce of float32 scores of
    ``shape`` in compiled HLO."""
    pat = "f32[" + ",".join(str(d) for d in shape) + "]"
    return [re.search(r"replica_groups=(\S+?),? ", line).group(1)
            for line in text.splitlines()
            if " all-reduce(" in line and pat in line.split("=")[1]]

toks = jnp.asarray(data["toks"])
l = B.get_arch({phi!r}).reduced()
params0 = jax.tree.map(jnp.asarray, data["params"][{phi!r}])
out = {{"phi": {{}}, "mamba": {{}}}}
ocfg = OptConfig(name="adamw", total_steps={steps})
dcfg = DataConfig(vocab=l.vocab, seq_len=32, global_batch=8, seed=3)
for shape in {shapes!r}:
    r = {{}}
    with ctx.use_mesh(mesh(shape)):
        pspecs = ST.resolve_tree(M.param_specs(l))
        p_sh = jax.device_put(params0, pspecs)
        t_sh = jax.device_put(toks, ctx.named_sharding(("dp", None)))
        fw = jax.jit(lambda p, t: M.forward_train(p, t, l)[0])
        r["fw"] = np.asarray(fw(p_sh, t_sh))
        b_local = toks.shape[0] // shape[0]
        heads = l.n_heads // np.gcd(l.n_heads, shape[1])
        r["score_groups"] = score_groups(
            fw.lower(p_sh, t_sh).compile().as_text(),
            (b_local, heads, toks.shape[1], toks.shape[1]))
        csp = ST.resolve_tree(ST.stacked_cache_specs(l, toks.shape[0]))
        pre, cache = jax.jit(
            lambda p, t: M.prefill(p, t, l, max_len={max_len}),
            out_shardings=(None, csp))(p_sh, t_sh)
        r["prefill"] = np.asarray(pre)
        r["cache"] = host(cache)
        r["cache_local"] = cache["layer0"]["k"].sharding.shard_shape(
            cache["layer0"]["k"].shape)
        step = jax.jit(lambda p, c, t, pos: M.decode_step(p, c, t, pos, l))
        steps = []
        for s, feed in enumerate(data["feed"]):
            lg, cache = step(p_sh, cache, jnp.asarray(feed),
                             jnp.full((toks.shape[0],), {toks}[1] + s,
                                      jnp.int32))
            steps.append(np.asarray(lg))
        r["steps"] = steps
        ospecs = ST.resolve_tree(opt_state_specs(M.param_specs(l), ocfg))
        params = p_sh
        opt = jax.device_put(init_opt_state(params0, ocfg), ospecs)
        bspecs = ST.resolve_tree(ST.batch_specs(
            l, B.ShapeConfig("t", 32, 8, "train")))
        b0 = jax.device_put({{k: jnp.asarray(v) for k, v in
                              synth_batch(dcfg, 0).items()}}, bspecs)
        r["grads"] = host(jax.jit(jax.grad(lambda p, b: M.lm_loss(
            p, b["tokens"], b["targets"], l)))(params, b0))
        train = jax.jit(ST.make_train_step(l, ocfg),
                        in_shardings=(pspecs, ospecs, bspecs, None),
                        out_shardings=(pspecs, ospecs, None))
        losses = []
        for s in range({steps}):
            b = {{k: jnp.asarray(v) for k, v in synth_batch(dcfg, s).items()}}
            params, opt, met = train(params, opt, b, jnp.int32(s))
            losses.append(float(met["loss"]))
        r["losses"], r["params"] = losses, host(params)
    out["phi"][shape] = r

m = dataclasses.replace(B.get_arch({mamba!r}).reduced(), vocab={vocab},
                        loss_vocab_chunk={chunk})
params0 = jax.tree.map(jnp.asarray, data["params"][{mamba!r}])
with ctx.use_mesh(mesh((1, 4))):
    p_sh = jax.device_put(params0, ST.resolve_tree(M.param_specs(m)))
    tgt = jnp.asarray(data["mamba_tgt"])
    mt = jnp.asarray(data["mamba_toks"])
    out["mamba"]["fw"] = np.asarray(jax.jit(
        lambda p, t: M.forward_train(p, t, m)[0])(p_sh, mt))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t, y: M.lm_loss(p, t, y, m)))(p_sh, mt, tgt)
    out["mamba"]["loss"] = float(loss)
    out["mamba"]["grads"] = host(grads)
with open({out_file!r}, "wb") as f:
    pickle.dump(out, f)
print("REF-OK")
'''


# ---------------------------------------------------------------------------
# the inputs, drawn once and given to both packages
# ---------------------------------------------------------------------------

def _cfg(arch, **changes):
    from repro_torch.configs import base as B
    if arch == MAMBA:
        changes = dict(vocab=MAMBA_VOCAB, loss_vocab_chunk=MAMBA_CHUNK,
                       **changes)
    return dataclasses.replace(B.get_arch(arch).reduced(), **changes)


def _lut():
    return np.random.default_rng(5).integers(0, 65536, (256, 256))


def _inputs():
    from repro_torch import convert as C
    from repro_torch.models import model as M
    rng = np.random.default_rng(9)
    data = {"params": {},
            "toks": rng.integers(0, 256, TOKS).astype(np.int32),
            "feed": rng.integers(0, 256, (DEC_STEPS, TOKS[0], 1)
                                 ).astype(np.int32),
            "mamba_toks": rng.integers(0, MAMBA_VOCAB, TOKS
                                       ).astype(np.int32),
            "mamba_tgt": rng.integers(0, MAMBA_VOCAB, TOKS
                                      ).astype(np.int32)}
    for arch in (PHI, MAMBA):
        cfg = _cfg(arch)
        data["params"][arch] = C.reference_params(
            M.init_params(torch.Generator().manual_seed(11), cfg), cfg)
    return data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's runs; the port's one-rank run, the (2, 1) world's
    by rank, the (1, 4) world's, the (2, 4) world's), the reference and
    the worlds at once."""
    from repro_torch.parallel.spawn import run_ranks
    d = str(tmp_path_factory.mktemp("tp_heads"))
    data = _inputs()
    data_file, out_file = (os.path.join(d, n) for n in ("in.pkl",
                                                        "out.pkl"))
    with open(data_file, "wb") as f:
        pickle.dump(data, f)
    with ThreadPoolExecutor(4) as pool:
        ref = pool.submit(run_subprocess, REF_SCRIPT.format(
            data_file=data_file, out_file=out_file, phi=PHI, mamba=MAMBA,
            vocab=MAMBA_VOCAB, chunk=MAMBA_CHUNK, shapes=SHAPES, toks=TOKS,
            max_len=MAX_LEN, steps=TRAIN_STEPS), 8, 900)
        worlds = [pool.submit(run_ranks, _world, n, data, timeout_s=600.0,
                              workdir=d) for n in (1, 2, 4)]
        eight = run_ranks(_world, 8, data, timeout_s=600.0, workdir=d)
        one, two, four = (w.result() for w in worlds)
        assert "REF-OK" in ref.result()
    with open(out_file, "rb") as f:
        return pickle.load(f), (one[0], two, four, eight)


# ---------------------------------------------------------------------------
# the port's runs
# ---------------------------------------------------------------------------

def _mesh(world):
    from repro_torch.launch import mesh as meshes
    shape = {1: None, 2: (2, 1), 4: (1, 4), 8: (2, 4)}[world]
    return None if shape is None else meshes.make_debug_mesh(
        *shape, device="cpu")


def _tokens(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.int64)


def _whole(t, sharding):
    from repro_torch.parallel import collectives as coll
    return coll.gather(t, sharding).numpy()


class _Seen:
    """Within the block: the FLOPs (FlopCounterMode) of every
    ``run_attention`` (the scores and p·v), and each collective's group
    ranks, op and input shape (``calls``)."""

    def __enter__(self):
        import torch.distributed as dist
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.models import attention as A
        from repro_torch.parallel import collectives as coll
        self.flops, self.calls = 0, []
        self.real = (A.run_attention, coll._gather, coll._reduce)

        def attend(*a, **kw):
            with FlopCounterMode(display=False) as fc:
                out = self.real[0](*a, **kw)
            self.flops += fc.get_total_flops()
            return out

        def gather(x, group, *a):
            self.calls.append(("all-gather", tuple(
                dist.get_process_group_ranks(group)), tuple(x.shape)))
            return self.real[1](x, group, *a)

        def reduce(x, group, *a):
            self.calls.append(("all-reduce", tuple(
                dist.get_process_group_ranks(group)), tuple(x.shape)))
            return self.real[2](x, group, *a)
        A.run_attention, coll._gather, coll._reduce = attend, gather, reduce
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as A
        from repro_torch.parallel import collectives as coll
        A.run_attention, coll._gather, coll._reduce = self.real


def _phi_serve(data, cfg):
    """(forward logits, prefill logits, the decode steps' logits, each
    layer's k / v caches whole, the first k cache's local shape)."""
    from repro_torch import convert as C
    from repro_torch.models import model as M
    from repro_torch.parallel import ctx
    params = C.model_params(data["params"][PHI], cfg, "cpu")
    toks = _tokens(data["toks"])
    B = toks.shape[0]
    with torch.no_grad():
        fw, _ = M.forward_train(params, toks, cfg)
        pre, cache = M.prefill(params, toks, cfg, max_len=MAX_LEN)
        local = tuple(cache[0]["k"].shape)
        whole = []
        for i, lc in enumerate(cache):
            sh = (M.layer_cache_shardings(cfg, B, i)
                  if ctx.get_mesh() is not None else {"k": None, "v": None})
            whole.append({k: _whole(lc[k], sh[k]) for k in ("k", "v")})
        steps = []
        for s, feed in enumerate(data["feed"]):
            lg, cache = M.decode_step(params, cache, _tokens(feed),
                                      torch.full((B,), TOKS[1] + s), cfg)
            steps.append(lg.numpy())
    return fw.numpy(), pre.numpy(), steps, whole, local


def _phi_train(data, cfg):
    """(step 0's gradients whole, TRAIN_STEPS AdamW steps' losses, the
    parameters after them whole), on the reference test's batches."""
    from repro_torch import convert as C
    from repro_torch import tree as T
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, init_opt_state
    from repro_torch.parallel import ctx
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=3)
    batches = [{k: _tokens(v) for k, v in synth_batch(dcfg, s).items()}
               for s in range(TRAIN_STEPS)]
    params = C.model_params(data["params"][PHI], cfg, "cpu")
    _, grads = ST.loss_and_grads(params, cfg, batches[0]["tokens"],
                                 batches[0]["targets"])
    if ctx.get_mesh() is not None:
        grads = store.gather_to_host(
            grads, ST.resolve_tree(M.param_specs(cfg)), True)
    grads = [store.to_host(g) for g in T.leaves(grads)]
    ocfg = OptConfig(name="adamw", total_steps=TRAIN_STEPS)
    params = C.model_params(data["params"][PHI], cfg, "cpu")
    state = init_opt_state(C.reference_tree(params, cfg), ocfg)
    step = ST.make_train_step(cfg, ocfg)
    losses = []
    for s, b in enumerate(batches):
        params, state, met = step(params, state, b, s)
        losses.append(float(met["loss"]))
    return grads, losses, list(T.leaves(C.reference_params(params, cfg)))


def _phi_block(data, cfg):
    """A forward of the first layer's mixer block on seeded activations:
    (its score and p·v FLOPs, its collectives)."""
    from repro_torch import convert as C
    from repro_torch.models import model as M
    params = C.model_params(data["params"][PHI], cfg, "cpu")
    x = torch.randn((4, 12, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), _Seen() as seen:
        M._mixer_block(M.layer_spec(cfg, 0), params.layers[0],
                       M._rows(x, M._dp_split(4)), cfg)
    return seen.flops, seen.calls


def _lut_logits(data, cfg):
    """The forward's, the prefill's and the decode steps' logits on the
    approximate multiplier, and the outputs of the first mixer block's
    column-parallel projections (wq, wk, wv) on seeded activations."""
    from repro_torch import convert as C
    from repro_torch.models import model as M
    from repro_torch.models import quant
    quant.set_multiplier_lut(_lut())
    real, seen = quant.approx_matmul, []

    def rec(x, w, *a, row=False, **kw):
        out = real(x, w, *a, row=row, **kw)
        if not row:
            seen.append(out.numpy())
        return out
    try:
        fw, pre, steps, _, _ = _phi_serve(data, cfg)
        params = C.model_params(data["params"][PHI], cfg, "cpu")
        x = torch.randn((4, 12, cfg.d_model),
                        generator=torch.Generator().manual_seed(2))
        quant.approx_matmul = rec
        with torch.no_grad(), M._batch(4):
            M._mixer_block(M.layer_spec(cfg, 0), params.layers[0],
                           M._rows(x, M._dp_split(4)), cfg)
    finally:
        quant.approx_matmul = real
        quant.set_multiplier_lut(None)
    return [fw, pre] + steps, seen


def _mamba(data):
    """(forward logits, loss, its gradients whole, the collectives of the
    forward and of the loss's forward and backward)."""
    from repro_torch import convert as C
    from repro_torch import tree as T
    from repro_torch.checkpoint import store
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.parallel import ctx
    cfg = _cfg(MAMBA)
    params = C.model_params(data["params"][MAMBA], cfg, "cpu")
    toks, tgt = _tokens(data["mamba_toks"]), _tokens(data["mamba_tgt"])
    with _Seen() as seen:
        with torch.no_grad():
            fw, _ = M.forward_train(params, toks, cfg)
        loss, grads = ST.loss_and_grads(params, cfg, toks, tgt)
    if ctx.get_mesh() is not None:
        grads = store.gather_to_host(
            grads, ST.resolve_tree(M.param_specs(cfg)), True)
    return (fw.numpy(), float(loss),
            [store.to_host(g) for g in T.leaves(grads)], seen.calls)


def _world(rank, world, data):
    """The one-rank runs (world 1), the dp split alone (2: (2, 1), the
    LUT), (1, 4) (4) and (2, 4) (8)."""
    from repro_torch.parallel import ctx
    cfg = _cfg(PHI)
    lut = _cfg(PHI, approx_matmul=True)
    out = {}
    with ctx.use_mesh(_mesh(world)):
        out["lut"] = _lut_logits(data, lut)
        if world == 2:
            return out
        out["serve"] = _phi_serve(data, cfg)
        out["train"] = _phi_train(data, cfg)
        out["block"] = _phi_block(data, cfg)
        if world in (1, 4):
            out["mamba"] = _mamba(data)
    return out


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _outs(runs, shape):
    _, (_, _, four, eight) = runs
    return four if shape == (1, 4) else eight


def _pairs(world_shape):
    """The ranks of each head group: 2 consecutive "model" ranks."""
    n = int(np.prod(world_shape))
    return {tuple(range(r, r + 2)) for r in range(0, n, 2)}


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_forward_against_reference(runs, shape):
    """phi4-mini's forward logits on every rank within the float32
    tolerance of the reference's GSPMD forward on the same mesh and of the
    port's one-rank forward."""
    ref, (one, _, _, _) = runs
    for out in _outs(runs, shape):
        _close(out["serve"][0], ref["phi"][shape]["fw"])
        _close(out["serve"][0], one["serve"][0])


@pytest.mark.parametrize("shape", SHAPES)
def test_training_against_reference(runs, shape):
    """Step 0's gradients gathered whole, 3 AdamW steps' losses and the
    parameters after them: within the float32 tolerance (losses within
    LOSS_RTOL) of the reference's sharded training and of one rank's.  A
    scores' all-reduce whose backward passed the gradient through (each
    rank's p·v gives only its slice's part) fails here."""
    from repro_torch import tree as T
    ref, (one, _, _, _) = runs
    want = ref["phi"][shape]
    ref_grads = [np.asarray(g) for g in T.leaves(want["grads"])]
    ref_params = [np.asarray(p) for p in T.leaves(want["params"])]
    w_grads, w_losses, w_params = one["train"]
    for out in _outs(runs, shape):
        grads, losses, params = out["train"]
        for g, r, w in zip(grads, ref_grads, w_grads):
            _close(g, r)
            _close(g, w)
        np.testing.assert_allclose(losses, want["losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(losses, w_losses, rtol=LOSS_RTOL)
        for p, r, w in zip(params, ref_params, w_params):
            _close(p, r)
            _close(p, w)


@pytest.mark.parametrize("shape", SHAPES)
def test_prefill_caches_at_rest_match_reference(runs, shape):
    """The prefill writes each layer's cache at rest in the reference's
    ``cache_specs`` layout (head_dim split over "model", every kv head:
    (B / dp, MAX_LEN, 2, 4) a rank), moved there from the head groups'
    compute layout; whole, each equals the reference's prefill cache
    within the float32 tolerance, and the prefill's logits too."""
    ref, _ = runs
    want = ref["phi"][shape]
    cfg = _cfg(PHI)
    for out in _outs(runs, shape):
        _, pre, _, whole, local = out["serve"]
        assert local == tuple(want["cache_local"][1:]) == (
            TOKS[0] // shape[0], MAX_LEN, cfg.n_kv_heads, cfg.hd // 4)
        for i, lc in enumerate(whole):
            for k in ("k", "v"):
                _close(lc[k], want["cache"]["layer0"][k][i])
        _close(pre, want["prefill"])


@pytest.mark.parametrize("shape", SHAPES)
def test_decode_after_the_prefill_against_reference(runs, shape):
    """DEC_STEPS decode steps on the cache that prefill wrote (the decode
    on a head_dim-split cache): each step's logits within the float32
    tolerance of the reference's jitted decode and of one rank's."""
    ref, (one, _, _, _) = runs
    for out in _outs(runs, shape):
        for a, b, c in zip(out["serve"][2], ref["phi"][shape]["steps"],
                           one["serve"][2]):
            _close(a, b)
            _close(a, c)


def test_lut_projections_are_one_ranks_bit_for_bit(runs):
    """On the approximate multiplier each rank's q / k / v projections (its
    columns, column-parallel as they lie) equal the same columns of one
    rank's bit for bit (the ranges are the whole weight's): on (1, 4)
    one rank's, on (2, 4) the (2, 1) run's rows (a dp split alone moves
    the float products' rounding)."""
    _, (one, two, four, eight) = runs
    for outs, want, dp in ((four, one["lut"][1], 1),
                           (eight, None, 2)):
        for rank, out in enumerate(outs):
            d, m = divmod(rank, 4)
            ref = want if dp == 1 else two[d]["lut"][1]
            got = out["lut"][1]
            assert len(got) == len(ref) == 3
            for a, b in zip(got, ref):
                w = a.shape[-1]
                assert np.array_equal(a, b[..., m * w:(m + 1) * w])


def test_lut_tokens_against_one_rank(runs):
    """On the approximate multiplier the forward's, the prefill's and each
    decode step's greedy tokens on (1, 4) are one rank's (on (2, 4) the
    (2, 1) run's), or split where that run's top two logits lie within
    TIE_ATOL or twice that pass's largest difference: the scores' partial
    sums round otherwise than the whole sum, and a rounding may move a
    uint8 operand of ``wo`` by a step (the float path is within RTOL)."""
    _, (one, two, four, eight) = runs
    for outs, want in ((four, one["lut"][0]), (eight, two[0]["lut"][0])):
        for out in outs:
            assert len(out["lut"][0]) == len(want) == DEC_STEPS + 2
            for g, w in zip(out["lut"][0], want):
                step = float(np.abs(g - w).max())
                ga, wa = g[:, -1].argmax(-1), w[:, -1].argmax(-1)
                for b in np.nonzero(ga != wa)[0]:
                    top = np.sort(w[b, -1])[-2:]
                    assert top[1] - top[0] <= max(TIE_ATOL, 2 * step)


@pytest.mark.parametrize("shape", SHAPES)
def test_score_and_pv_flops_are_a_quarter(runs, shape):
    """FlopCounterMode around the attention of a mixer block: a rank's
    score and p·v FLOPs are exactly one quarter of one rank's (3 heads ×
    half of head_dim)."""
    _, (one, _, _, _) = runs
    for out in _outs(runs, shape):
        got = out["block"][0] * (shape[0] if shape[0] > 1 else 1)
        assert got * 4 == one["block"][0] > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_scores_are_summed_within_the_head_groups(runs, shape):
    """The attention block's collectives on every rank: the scores' float32
    all-reduces and the q / k / v and output gathers run within the rank's
    pair of "model" ranks, {0, 1} or {2, 3} (and {4, 5}, {6, 7} on the
    second dp row); the one all-reduce over all of "model" is *g* after
    ``wo``; no gather spans "model" (no weight is gathered there).  The
    reference's compiled forward all-reduces its (B / dp, 3, S, S) scores
    in the same pairs."""
    ref, _ = runs
    pairs = _pairs(shape)
    lines = {tuple(range(r, r + 4)) for r in range(0, 4 * shape[0], 4)}
    cols = {tuple(range(m, 4 * shape[0], 4)) for m in range(4)}
    for rank, out in enumerate(_outs(runs, shape)):
        calls = out["block"][1]
        scores = [c for c in calls if c[0] == "all-reduce" and len(c[2]) == 4]
        assert scores and all(c[1] in pairs and rank in c[1]
                              for c in scores), calls
        other = [c for c in calls if c not in scores]
        assert [c[1] for c in other if c[0] == "all-reduce"] == \
            [line for line in lines if rank in line], calls
        gathers = [c[1] for c in other if c[0] == "all-gather"]
        assert gathers and all(g in pairs or g in cols for g in gathers)
        assert not any(g in lines for g in gathers), calls
    want = {(1, 4): "[2,2]<=[4]", (2, 4): "[4,2]<=[8]"}[shape]
    assert ref["phi"][shape]["score_groups"] and all(
        g == want for g in ref["phi"][shape]["score_groups"])


def test_mamba_vocab_on_the_d_model_split_table(runs):
    """mamba2 with a vocabulary of 250 on (1, 4): the table at rest splits
    d_model (16 columns a rank); forward logits, the chunked loss and its
    gradients within the float32 tolerance (loss LOSS_RTOL) of the
    reference's GSPMD run and of one rank's; the embedding gathers the
    rank's (4, 12, 16) lookups, the head all-reduces the partial logits,
    and no gather moves the table (no tensor with the vocabulary's 250
    rows)."""
    from repro_torch import tree as T
    ref, (one, _, four, _) = runs
    want = ref["mamba"]
    ref_grads = [np.asarray(g) for g in T.leaves(want["grads"])]
    w_fw, w_loss, w_grads, _ = one["mamba"]
    for out in four:
        fw, loss, grads, calls = out["mamba"]
        _close(fw, want["fw"])
        _close(fw, w_fw)
        np.testing.assert_allclose(loss, want["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(loss, w_loss, rtol=LOSS_RTOL)
        for g, r, w in zip(grads, ref_grads, w_grads):
            _close(g, r)
            _close(g, w)
        assert ("all-gather", (0, 1, 2, 3), (4, 12, 16)) in calls, calls
        assert ("all-reduce", (0, 1, 2, 3), (4, 12, MAMBA_VOCAB)) in calls
        assert not any(op == "all-gather" and MAMBA_VOCAB in shape
                       for op, _, shape in calls), calls
