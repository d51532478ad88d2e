"""The decode on a head_dim-split KV cache, on gloo CPU ranks
(``parallel.spawn.run_ranks``), against the JAX package's jitted decode on
forced host devices and the port's one-rank runs.

Where the kv heads do not divide over "tp" and head_dim does, the cache
splits head_dim at rest (the reference's ``cache_specs``), and the
reference's ``decode_self_attention(kv_spec=...)`` computes on that split:
each device's scores are partial sums over its head_dim slice, summed over
"tp", and p·v stays on the slice.  The port does the same
(``attention.decode_self_attention(hd_axes=)``).  Two reduced models on
(1, 4): the llama (8 query heads, 2 kv heads, hd 8: the query heads
divide) and phi4-mini (6 query heads, 2 kv heads, hd 16: they do not).

The reference runs once, in a subprocess with 4 host devices on a mesh
with ``Auto`` axis types (as ``tests/test_torch_tensor_parallel.py``'s);
the parameters are drawn by the port from a seed and handed to both.  Its
compiled decode's HLO is read for its collectives.  Tolerances are
``tests/test_torch_tensor_parallel.py``'s: RTOL / ATOL (float32) for
logits.  On the approximate multiplier (a product table near the exact
one) the tokens equal one rank's or split where one rank's top two logits
lie within TIE_ATOL.  Exact: a rank's score and p·v FLOPs are one
quarter of one rank's.

The last test replays ``chip_smoke.py`` phase 22 (g)'s path (tensor-
parallel cross-attention of the vision model on (1, 2), the blocked
attention, cross gates open, an approximate table, each rank fed one
rank's tokens) at the reduced width: the logits are one rank's bit for
bit, so the port's arithmetic there is one rank's.
"""
import dataclasses
import os
import pickle
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from conftest import run_subprocess

torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
TIE_ATOL = 1e-3
ARCHS = ("llama3_2_1b", "phi4_mini_3_8b")
SHAPE = (1, 4)
TOKS = (4, 12)
DEC_STEPS = 4
MAX_LEN = TOKS[1] + DEC_STEPS
VISION = "llama3_2_vision_11b"
VISION_LAYERS = 4          # two periods: a cross and a self layer each
VISION_MAX_LEN = 20        # != the reduced model's 16 image tokens
GATE = 0.75
COLLECTIVES = ("all-gather", "all-reduce", "all-to-all",
               "collective-permute", "reduce-scatter")

REF_SCRIPT = r'''
import dataclasses, pickle, re
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import base as B
from repro.models import model as M
from repro.parallel import ctx
from repro.launch import steps as ST

mesh = jax.make_mesh({shape!r}, ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
with open({data_file!r}, "rb") as f:
    data = pickle.load(f)

def collectives(text):
    """(op, [(dtype, dims), ...]) of every collective in compiled HLO."""
    out = []
    for line in text.splitlines():
        m = re.search(r"= (.*?) ({ops})(-start)?\(", line)
        if m:
            shapes = [(d, tuple(int(x) for x in s.split(",") if x))
                      for d, s in re.findall(r"(\w+)\[([\d,]*)\]",
                                             m.group(1))]
            out.append((m.group(2), shapes))
    return out

def decode_hlo(params, cache, cfg, batch):
    step = jax.jit(lambda p, c, t, pos: M.decode_step(p, c, t, pos, cfg))
    t = jnp.zeros((batch, 1), jnp.int32)
    pos = jnp.full((batch,), {toks}[1], jnp.int32)
    return step, collectives(step.lower(params, cache, t, pos).compile()
                             .as_text())

out = {{}}
toks = jnp.asarray(data["toks"])
for arch in {archs!r}:
    l = B.get_arch(arch).reduced()
    params0 = jax.tree.map(jnp.asarray, data["params"][arch])
    pre, cache0 = M.prefill(params0, toks, l, max_len={max_len})
    with ctx.use_mesh(mesh):
        p_sh = jax.device_put(params0, ST.resolve_tree(M.param_specs(l)))
        cache = jax.device_put(cache0, ST.resolve_tree(
            ST.stacked_cache_specs(l, toks.shape[0])))
        step, hlo = decode_hlo(p_sh, cache, l, toks.shape[0])
        steps = []
        for s, feed in enumerate(data["feed"]):
            lg, cache = step(p_sh, cache, jnp.asarray(feed),
                             jnp.full((toks.shape[0],), {toks}[1] + s,
                                      jnp.int32))
            steps.append(np.asarray(lg))
    out[arch] = dict(prefill=np.asarray(pre), steps=steps, hlo=hlo)

v = B.get_arch({vision!r}).reduced()
v = dataclasses.replace(v, n_layers={vision_layers})
params0 = jax.tree.map(jnp.asarray, data["params"][{vision!r}])
img = jnp.asarray(data["img"])
_, cache0 = M.prefill(params0, toks, v, max_len={vision_max_len},
                      image_embeds=img)
with ctx.use_mesh(mesh):
    p_sh = jax.device_put(params0, ST.resolve_tree(M.param_specs(v)))
    cache = jax.device_put(cache0, ST.resolve_tree(
        ST.stacked_cache_specs(v, toks.shape[0])))
    out[{vision!r}] = dict(hlo=decode_hlo(p_sh, cache, v,
                                          toks.shape[0])[1])
with open({out_file!r}, "wb") as f:
    pickle.dump(out, f)
print("REF-OK")
'''


# ---------------------------------------------------------------------------
# the inputs, drawn once and given to both packages
# ---------------------------------------------------------------------------

def _cfg(arch, **changes):
    from repro_torch.configs import base as B
    if arch == VISION:
        changes.setdefault("n_layers", VISION_LAYERS)
    return dataclasses.replace(B.get_arch(arch).reduced(), **changes)


def _near_exact_lut():
    """An approximate 8x8 multiplier's table: each product off by up to
    ±64, as an evolved circuit's (the served model's elite is one)."""
    a = np.arange(256)
    noise = np.random.default_rng(5).integers(-64, 65, (256, 256))
    return np.clip(a[:, None] * a[None, :] + noise, 0, None)


def _inputs():
    """Each configuration's parameters (the reference's tree, drawn by the
    port from a seed; the vision model's cross gates at GATE), the prompt
    tokens, the decode steps' tokens, the image embeddings."""
    from repro_torch import convert as C
    from repro_torch.models import model as M
    rng = np.random.default_rng(9)
    data = {"params": {},
            "toks": rng.integers(0, 256, TOKS).astype(np.int32),
            "feed": rng.integers(0, 256, (DEC_STEPS, TOKS[0], 1)
                                 ).astype(np.int32)}
    for arch in ARCHS + (VISION,):
        cfg = _cfg(arch)
        tree = C.reference_params(
            M.init_params(torch.Generator().manual_seed(11), cfg), cfg)
        for i, spec in enumerate(cfg.period):
            if spec.cross_attn:
                g = tree["layers"][f"layer{i}"]["mixer"]["gate"]
                tree["layers"][f"layer{i}"]["mixer"]["gate"] = \
                    np.full_like(g, GATE)
        data["params"][arch] = tree
    v = _cfg(VISION)
    data["img"] = rng.standard_normal(
        (TOKS[0], v.n_img_tokens, v.d_model)).astype(np.float32)
    return data


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's runs by arch; the port's one-rank run, the 4-rank
    world's results by rank, the 2-rank world's), the reference and the
    first worlds at once; the 4-rank world is fed the one-rank run's
    greedy tokens on the approximate table."""
    from repro_torch.parallel.spawn import run_ranks
    d = str(tmp_path_factory.mktemp("tp_hd"))
    data = _inputs()
    data_file, out_file = (os.path.join(d, n) for n in ("in.pkl",
                                                        "out.pkl"))
    with open(data_file, "wb") as f:
        pickle.dump(data, f)
    with ThreadPoolExecutor(3) as pool:
        ref = pool.submit(run_subprocess, REF_SCRIPT.format(
            data_file=data_file, out_file=out_file, archs=ARCHS,
            shape=SHAPE, toks=TOKS, max_len=MAX_LEN, vision=VISION,
            vision_layers=VISION_LAYERS, vision_max_len=VISION_MAX_LEN,
            ops="|".join(COLLECTIVES)), 4, 900)
        one = pool.submit(run_ranks, _world, 1, data, None, timeout_s=600.0,
                          workdir=d).result()[0]
        feeds = {a: one[a]["lut_fed"] for a in ARCHS}
        feeds[VISION] = one[VISION]["fed"]
        two = pool.submit(run_ranks, _world, 2, data, feeds,
                          timeout_s=600.0, workdir=d)
        four = run_ranks(_world, 4, data, feeds, timeout_s=600.0, workdir=d)
        two = two.result()
        assert "REF-OK" in ref.result()
    with open(out_file, "rb") as f:
        return pickle.load(f), (one, four, two)


# ---------------------------------------------------------------------------
# the port's runs, the same on every world
# ---------------------------------------------------------------------------

def _mesh(world):
    from repro_torch.launch import mesh as meshes
    shape = {1: None, 2: (1, 2), 4: SHAPE}[world]
    return None if shape is None else meshes.make_debug_mesh(
        *shape, device="cpu")


def _params(data, arch, cfg):
    from repro_torch import convert as C
    return C.model_params(data["params"][arch], cfg, "cpu")


def _tokens(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.int64)


class _Seen:
    """Within the block, the shape of the k cache each self-attention
    decode computes on (``shapes``), the FLOPs (FlopCounterMode) of its
    scores and p·v (``flops``) and the calls of ``collectives.reshard``
    (``reshards``)."""

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        from repro_torch.models import attention as A
        from repro_torch.parallel import collectives as coll
        self.shapes, self.flops, self.reshards = [], 0, 0
        self.real = (A.decode_self_attention, A._masked_decode_attn,
                     coll.reshard)

        def decode(params, x, k, v, *a, **kw):
            self.shapes.append(tuple(k.shape))
            return self.real[0](params, x, k, v, *a, **kw)

        def attend(*a, **kw):
            with FlopCounterMode(display=False) as fc:
                out = self.real[1](*a, **kw)
            self.flops += fc.get_total_flops()
            return out
        def reshard(*a, **kw):
            self.reshards += 1
            return self.real[2](*a, **kw)
        A.decode_self_attention, A._masked_decode_attn, coll.reshard = (
            decode, attend, reshard)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention as A
        from repro_torch.parallel import collectives as coll
        (A.decode_self_attention, A._masked_decode_attn,
         coll.reshard) = self.real


def _decode(params, cfg, toks, feed, image_embeds=None, max_len=MAX_LEN):
    """A prefill, then a decode step for each of ``feed`` (None: the last
    step's argmax): (prefill logits, each step's logits, the tokens fed,
    the first layer's cache at rest, ``_Seen``)."""
    from repro_torch.models import model as M
    B = toks.shape[0]
    with torch.no_grad():
        pre, cache = M.prefill(params, toks, cfg, max_len=max_len,
                               image_embeds=image_embeds)
        tok, steps, fed = pre[:, -1].argmax(-1), [], []
        with _Seen() as seen:
            for s, want in enumerate(feed):
                tok = tok if want is None else _tokens(want).reshape(B)
                fed.append(tok.numpy())
                lg, cache = M.decode_step(
                    params, cache, tok[:, None],
                    torch.full((B,), toks.shape[1] + s), cfg)
                steps.append(lg.numpy())
                tok = lg[:, -1].argmax(-1)
    return pre.numpy(), steps, fed, tuple(cache[0]["k"].shape), seen


def _world(rank, world, data, feeds):
    """The one-rank runs (world 1), the hd-split ones on (1, 4) (world 4)
    or (g)'s replay on (1, 2) (world 2)."""
    from repro_torch.models import quant
    from repro_torch.parallel import ctx
    toks = _tokens(data["toks"])
    out = {}
    with ctx.use_mesh(_mesh(world)):
        for arch in (ARCHS if world != 2 else ()):
            cfg = _cfg(arch)
            pre, steps, _, rest, seen = _decode(
                _params(data, arch, cfg), cfg, toks, data["feed"])
            r = {"prefill": pre, "steps": steps, "rest": rest,
                 "compute": seen.shapes[0], "attn_flops": seen.flops,
                 "reshards": seen.reshards}
            lcfg = _cfg(arch, approx_matmul=True)
            quant.set_multiplier_lut(_near_exact_lut())
            try:
                feed = feeds[arch] if feeds else [None] * DEC_STEPS
                _, r["lut"], r["lut_fed"], _, _ = _decode(
                    _params(data, arch, lcfg), lcfg, toks, feed)
            finally:
                quant.set_multiplier_lut(None)
            out[arch] = r
        if world != 4:
            cfg = _cfg(VISION, approx_matmul=True, attn_impl="blocked")
            quant.set_multiplier_lut(_near_exact_lut())
            try:
                feed = feeds[VISION] if feeds else [None] * DEC_STEPS
                pre, steps, fed, _, _ = _decode(
                    _params(data, VISION, cfg), cfg, toks, feed,
                    torch.as_tensor(data["img"]), VISION_MAX_LEN)
            finally:
                quant.set_multiplier_lut(None)
            out[VISION] = {"logits": [pre] + steps, "fed": fed}
    return out


def _fake_decode_calls(arch):
    """Each collective (op, output bytes) of rank 0's decode step of the
    reduced ``arch`` on a fake (1, 4) world, counted by ``launch/dryrun``'s
    ``Counter`` on fake tensors; and the cell's (batch, length)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import base as B
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import ctx

    class Calls(D.Counter):
        def __init__(self):
            super().__init__()
            self.log = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "c10d" and func._opname in D.COLLECTIVES:
                self.log.append((D.COLLECTIVES[func._opname], sum(
                    D._bytes(t) for t in D._tensors(args[0]))))
            return super().__torch_dispatch__(func, types, args, kwargs)

    shape = B.ShapeConfig("decode_hd", 64, 4, "decode")
    with D.fake_world(4):
        mesh = make_debug_mesh(*SHAPE, device="cpu")
        with ctx.use_mesh(mesh), FakeTensorMode(allow_non_fake_inputs=True):
            fn, args, cfg = D.build_cell(arch, shape, "cpu", _cfg(arch))
            calls = Calls()
            with calls:
                fn(*args)
    return calls.log, cfg, (shape.global_batch, shape.seq_len)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_against_reference(runs, arch):
    """Prefill and DEC_STEPS decode steps on (1, 4), every rank: the
    logits within the float32 tolerance of the reference's jitted
    ``decode_step`` on the same mesh (caches placed by its
    ``stacked_cache_specs``) and of the port's one-rank run."""
    ref, (one, four, _) = runs
    want = ref[arch]
    for out in four:
        got = out[arch]
        _close(got["prefill"], want["prefill"])
        for a, b, c in zip(got["steps"], want["steps"], one[arch]["steps"]):
            _close(a, b)
            _close(a, c)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_stays_split_on_head_dim(runs, arch):
    """A rank's cache is (B, S, Hkv, hd / 4) at rest and in the compute:
    the decode steps attend to it as it lies, calling no ``reshard``; one
    rank's is whole."""
    _, (one, four, _) = runs
    cfg = _cfg(arch)
    local = (TOKS[0], MAX_LEN, cfg.n_kv_heads, cfg.hd // SHAPE[1])
    for out in four:
        assert out[arch]["rest"] == out[arch]["compute"] == local
        assert out[arch]["reshards"] == 0
    assert one[arch]["compute"] == (TOKS[0], MAX_LEN, cfg.n_kv_heads,
                                    cfg.hd)


@pytest.mark.parametrize("arch", ARCHS)
def test_lut_tokens_against_one_rank(runs, arch):
    """On the approximate multiplier each rank, fed one rank's greedy
    tokens, picks one rank's token at every step, or splits where one
    rank's top two logits lie within TIE_ATOL or twice that step's largest
    difference (the scores' partial sums round otherwise than the whole
    sum, and a rounding may move a uint8 operand by a step)."""
    _, (one, four, _) = runs
    want = one[arch]["lut"]
    for out in four:
        for g, w in zip(out[arch]["lut"], want):
            step = float(np.abs(g - w).max())
            ga, wa = g[:, -1].argmax(-1), w[:, -1].argmax(-1)
            for b in np.nonzero(ga != wa)[0]:
                top = np.sort(w[b, -1])[-2:]
                assert top[1] - top[0] <= max(TIE_ATOL, 2 * step), (b, top)


@pytest.mark.parametrize("arch", ARCHS)
def test_score_and_pv_flops_are_a_quarter(runs, arch):
    """FlopCounterMode around the scores and p·v: a rank's FLOPs over the
    decode steps are exactly one quarter of one rank's."""
    _, (one, four, _) = runs
    for out in four:
        assert out[arch]["attn_flops"] * SHAPE[1] == one[arch]["attn_flops"]
        assert out[arch]["attn_flops"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_collectives_on_a_fake_world(arch):
    """``launch/dryrun.py``'s Counter on rank 0 of a fake (1, 4) world: a
    decode step issues no all-gather of a cache's size (B·S·Hkv·hd), one
    B·H·S float32 all-reduce of the scores per layer, and every other
    collective moves at most B·(H + 2·Hkv)·hd elements (the new token's
    q, k and v gathered; the attention's output gathered: B·H·hd) or the
    logits' (B·vocab)."""
    log, cfg, (B, S) = _fake_decode_calls(arch)
    item = torch.empty((), dtype=cfg.adtype()).element_size()
    cache = B * S * cfg.n_kv_heads * cfg.hd * item
    scores = B * cfg.n_heads * S * 4
    qkv = B * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd * item
    assert all(n < cache for op, n in log if op == "all-gather"), log
    assert [n for op, n in log if op == "all-reduce"
            and n > qkv].count(scores) == cfg.n_layers, log
    big = [(op, n) for op, n in log if n > qkv
           and not (op == "all-reduce" and n == scores)]
    assert set(big) <= {("all-gather", B * cfg.vocab * item)}, big
    assert ("all-gather", qkv) in log
    assert ("all-gather", B * cfg.n_heads * cfg.hd * item) in log


def _cache_sized_gathers(hlo, cache):
    """The all-gathers in compiled HLO whose output has ``cache``'s
    shape (a whole layer's k or v cache)."""
    return [s for op, shapes in hlo if op == "all-gather"
            for _, s in shapes if s == cache]


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_decode_gathers_no_cache(runs, arch):
    """The reference's own compiled decode on (1, 4) gathers no
    cache-sized tensor either, and all-reduces (B, Hkv, S, 1, g) float32
    scores: the port's collectives are held to the reference's kinds."""
    ref, _ = runs
    cfg = _cfg(arch)
    hlo = ref[arch]["hlo"]
    cache = (TOKS[0], MAX_LEN, cfg.n_kv_heads, cfg.hd)
    assert _cache_sized_gathers(hlo, cache) == []
    g = cfg.n_heads // cfg.n_kv_heads
    scores = ("f32", (TOKS[0], cfg.n_kv_heads, MAX_LEN, 1, g))
    assert any(op == "all-reduce" and scores in shapes
               for op, shapes in hlo), hlo


def test_reference_gathers_the_cross_cache(runs):
    """The vision model's cross K/V cache (kv heads not dividing over 4,
    head_dim split at rest) is gathered whole by the reference's compiled
    decode, its self-attention cache is not: so the port gathers the cross
    cache and decodes on the split self-attention cache."""
    ref, _ = runs
    cfg = _cfg(VISION)
    hlo = ref[VISION]["hlo"]
    cross = (TOKS[0], cfg.n_img_tokens, cfg.n_kv_heads, cfg.hd)
    self_ = (TOKS[0], VISION_MAX_LEN, cfg.n_kv_heads, cfg.hd)
    assert len(_cache_sized_gathers(hlo, cross)) >= 2
    assert _cache_sized_gathers(hlo, self_) == []


def test_cross_attention_replay_is_one_ranks(runs):
    """``chip_smoke.py`` phase 22 (g)'s path at the reduced width (the
    vision model at two periods on (1, 2), blocked attention, cross gates
    open, a near-exact approximate table, each rank fed one rank's greedy
    tokens): the prefill's and every step's logits are one rank's bit for
    bit, the cross blocks on the rank's heads and kv heads included."""
    _, (one, _, two) = runs
    want = one[VISION]["logits"]
    for out in two:
        got = out[VISION]["logits"]
        assert len(got) == DEC_STEPS + 1
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
