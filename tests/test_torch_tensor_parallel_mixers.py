"""Tensor-parallel compute of the SSM mixer and of cross-attention over the
mesh's "model" axis, on gloo CPU ranks (``parallel.spawn.run_ranks``),
against the JAX package's sharded runs on forced host devices and the
port's unsharded runs.

Each "model" rank computes its heads of the SSM mixer (``ssm.ssm_tp``:
``w_z``, ``w_x``, ``w_dt`` column-parallel, ``w_out`` row-parallel, the B /
C branch whole) and of cross-attention (its query heads; at tp = 2 its kv
head, at tp = 4 the kv head its query heads share), as the reference's
GSPMD partitions them by their specs.  The reduced configurations: mamba2
(8 SSM heads, 2 layers) and the vision model (a cross and a
self-attention layer, 4 query and 2 kv heads) here, jamba (7 SSM layers,
one attention layer, MoE on the odd slots, expert-parallel on every mesh
here) in ``tests/test_torch_tensor_parallel_hybrid.py``, which runs the
same checks (two files, so each runs in its own worker); every cross
layer's gate is set to GATE (the reference's zero gate makes a cross
block the identity and its gradients zero) and the image embeddings are
random.

The parameters are drawn once, in this process, and handed to both
packages; the reference runs in a subprocess with 8 host devices on meshes
with ``Auto`` axis types (as ``tests/test_torch_tensor_parallel.py``'s),
beside the port's 1-, 2- and 4-rank worlds.  Tolerances are that file's:
RTOL / ATOL (float32) for logits, gradients and parameters, LOSS_RTOL for
losses.  Exact where both sides are: a rank's mixer FLOPs (the whole bc
branch on every rank, the rest a tp-th), and the approximate multiplier's
logits of the vision model on (1, 2).  Elsewhere the LUT logits are one
rank's within the float32 tolerance wherever every uint8 operand is one
rank's, and otherwise the first operand that differs is one step apart in
at most Q_FLIP_FRACTION of it (the SSM's gate norm sums its squares over
"tp" in another order: a rounding flip, as ``chip_smoke.py`` holds the
card's runs).
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
Q_FLIP_FRACTION = 0.01
TRAIN_STEPS = 3
DEC_STEPS = 3
GATE = 0.75
ARCHS = ("mamba2_1_3b", "llama3_2_vision_11b")
SHAPES = ((1, 2), (1, 4), (2, 2))
CASES = [(a, s) for a in ARCHS for s in SHAPES]
TOKS = (4, 12)

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

with open({data_file!r}, "rb") as f:
    data = pickle.load(f)
toks, tgt = jnp.asarray(data["toks"]), jnp.asarray(data["tgt"])
ocfg = OptConfig(name="adamw", total_steps={steps})
out = {{}}
for arch in {archs!r}:
    l = B.get_arch(arch).reduced()
    params0 = jax.tree.map(jnp.asarray, data["params"][arch])
    img = data["img"].get(arch)
    img = None if img is None else jnp.asarray(img)
    train_img = data["train_img"].get(arch)
    dcfg = DataConfig(vocab=l.vocab, seq_len=32, global_batch=8, seed=3)
    for shape in {shapes!r}:
        with ctx.use_mesh(mesh(shape)):
            pspecs = ST.resolve_tree(M.param_specs(l))
            p_sh = jax.device_put(params0, pspecs)
            fw = jax.jit(lambda p, t, i: M.forward_train(
                p, t, l, image_embeds=i)[0])(p_sh, toks, img)
            grads = jax.jit(jax.grad(lambda p, t, y, i: M.lm_loss(
                p, t, y, l, image_embeds=i)))(p_sh, toks, tgt, img)
            ospecs = ST.resolve_tree(opt_state_specs(M.param_specs(l), ocfg))
            bspecs = ST.resolve_tree(ST.batch_specs(
                l, B.ShapeConfig("t", 32, 8, "train")))
            opt = jax.device_put(init_opt_state(params0, ocfg), ospecs)
            step = jax.jit(ST.make_train_step(l, ocfg),
                           in_shardings=(pspecs, ospecs, bspecs, None),
                           out_shardings=(pspecs, ospecs, None))
            params, losses, before = p_sh, [], []
            for s in range({steps}):
                b = {{k: jnp.asarray(v) for k, v in
                      synth_batch(dcfg, s).items()}}
                if train_img is not None:
                    b["image_embeds"] = jnp.asarray(train_img)
                before.append((host(params), np.asarray(b["tokens"])))
                params, opt, met = step(params, opt, b, jnp.int32(s))
                losses.append(float(met["loss"]))
        # each dp row block's MoE aux at every step's parameters, off the
        # mesh (the capacity of its own tokens, as expert parallelism's)
        aux = jax.jit(lambda p, t: M.forward_train(p, t, l)[1])
        n = shape[0]
        row_aux = [[float(aux(p, t[r * len(t) // n:(r + 1) * len(t) // n]))
                    for r in range(n)] for p, t in before] \
            if any(sp.moe for sp in l.period) and n > 1 else None
        out[(arch, shape)] = dict(fw=np.asarray(fw), grads=host(grads),
                                  losses=losses, params=host(params),
                                  row_aux=row_aux)
with open({out_file!r}, "wb") as f:
    pickle.dump(out, f)
print("REF-OK")
'''


# ---------------------------------------------------------------------------
# the inputs, drawn once and given to both packages
# ---------------------------------------------------------------------------

def _cfg(arch, **changes):
    from repro_torch.configs import base as B
    return dataclasses.replace(B.get_arch(arch).reduced(), **changes)


def _gated(tree, cfg):
    """``tree`` (the reference's layout) with every cross layer's gate at
    GATE."""
    for i, spec in enumerate(cfg.period):
        if spec.cross_attn:
            g = tree["layers"][f"layer{i}"]["mixer"]["gate"]
            tree["layers"][f"layer{i}"]["mixer"]["gate"] = np.full_like(
                g, GATE)
    return tree


def _inputs(archs):
    """Each configuration's parameters (the reference's tree, drawn by the
    port from a seed), the tokens and targets, the image embeddings."""
    from repro_torch import convert as C
    from repro_torch.models import model as M
    rng = np.random.default_rng(9)
    data = {"params": {}, "img": {}, "train_img": {},
            "toks": rng.integers(0, 256, TOKS).astype(np.int32),
            "tgt": rng.integers(0, 256, TOKS).astype(np.int32)}
    for arch in archs:
        cfg = _cfg(arch)
        params = M.init_params(torch.Generator().manual_seed(11), cfg)
        data["params"][arch] = _gated(C.reference_params(params, cfg), cfg)
        if cfg.frontend == "vision":
            for key, rows in (("img", TOKS[0]), ("train_img", 8)):
                data[key][arch] = rng.standard_normal(
                    (rows, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return data


def make_runs(archs):
    """The module's ``runs`` fixture for ``archs``: (the reference's runs
    by (arch, shape); the port's: the unsharded run, the 2-rank world's
    results by rank, the 4-rank world's), the reference and the three
    worlds run at once."""
    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        from repro_torch.parallel.spawn import run_ranks
        d = str(tmp_path_factory.mktemp("tp_mixers"))
        data = _inputs(archs)
        data_file, out_file = (os.path.join(d, n) for n in ("in.pkl",
                                                            "out.pkl"))
        with open(data_file, "wb") as f:
            pickle.dump(data, f)
        with ThreadPoolExecutor(4) as pool:
            ref = pool.submit(run_subprocess, REF_SCRIPT.format(
                data_file=data_file, out_file=out_file, archs=archs,
                shapes=SHAPES, steps=TRAIN_STEPS), 8, 900)
            worlds = [pool.submit(run_ranks, _world, n, data, archs,
                                  timeout_s=600.0, workdir=d)
                      for n in (1, 2, 4)]
            one, two, four = (w.result() for w in worlds)
            assert "REF-OK" in ref.result()
        with open(out_file, "rb") as f:
            return pickle.load(f), (one[0], two, four)
    return runs


runs = make_runs(ARCHS)


# ---------------------------------------------------------------------------
# the port's runs, the same on every world
# ---------------------------------------------------------------------------

def _tokens(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.int64)


def _img(data, arch, key="img"):
    x = data[key].get(arch)
    return None if x is None else torch.as_tensor(x)


def _lut():
    return np.random.default_rng(5).integers(0, 65536, (256, 256))


def _mesh(shape):
    from repro_torch.launch import mesh as meshes
    return None if shape is None else meshes.make_debug_mesh(
        *shape, device="cpu")


def _params(data, arch, cfg):
    from repro_torch import convert as C
    return C.model_params(data["params"][arch], cfg, "cpu")


def _whole(tree, cfg):
    """The whole leaves of a gradient tree of this rank's slices."""
    from repro_torch import tree as T
    from repro_torch.checkpoint import store
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.parallel import ctx
    if ctx.get_mesh() is not None:
        tree = store.gather_to_host(tree, ST.resolve_tree(M.param_specs(
            cfg)), True)
    return [store.to_host(g) for g in T.leaves(tree)]


def _grads_and_train(data, arch):
    """(forward logits; the gradients of the loss on the tokens, whole,
    and their global norm from this rank's slices; TRAIN_STEPS AdamW
    steps: losses, whole parameters)."""
    from repro_torch import convert as C
    from repro_torch import tree as T
    from repro_torch.data.pipeline import DataConfig, synth_batch
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    from repro_torch.optim import OptConfig, global_norm, init_opt_state
    from repro_torch.parallel import ctx
    cfg = _cfg(arch)
    toks, tgt, img = (_tokens(data["toks"]), _tokens(data["tgt"]),
                      _img(data, arch))
    params = _params(data, arch, cfg)
    with torch.no_grad():
        fw, _ = M.forward_train(params, toks, cfg, img)
    _, grads = ST.loss_and_grads(params, cfg, toks, tgt, image_embeds=img)
    shardings = (ST.resolve_tree(M.param_specs(cfg))
                 if ctx.get_mesh() is not None else None)
    norm = float(global_norm(grads, shardings))
    grads = _whole(grads, cfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=3)
    ocfg = OptConfig(name="adamw", total_steps=TRAIN_STEPS)
    params = _params(data, arch, cfg)
    state = init_opt_state(C.reference_tree(params, cfg), ocfg)
    step = ST.make_train_step(cfg, ocfg)
    losses = []
    for s in range(TRAIN_STEPS):
        b = {k: _tokens(v) for k, v in synth_batch(dcfg, s).items()}
        if cfg.frontend == "vision":
            b["image_embeds"] = _img(data, arch, "train_img")
        params, state, met = step(params, state, b, s)
        losses.append(float(met["loss"]))
    return dict(fw=fw.numpy(), grads=grads, norm=norm, losses=losses,
                params=list(T.leaves(C.reference_params(params, cfg))))


def _remat_grads(data, arch):
    """(the loss, its gradients whole) with every layer recomputed in the
    backward pass (``remat_policy="block_outputs"``) and the loss in
    sequence chunks of 5, as the full configurations train."""
    from repro_torch.launch import steps as ST
    cfg = _cfg(arch, remat=True, remat_policy="block_outputs",
               loss_vocab_chunk=5)
    loss, grads = ST.loss_and_grads(
        _params(data, arch, cfg), cfg, _tokens(data["toks"]),
        _tokens(data["tgt"]), image_embeds=_img(data, arch))
    return float(loss), _whole(grads, cfg)


def _serve(data, arch, cfg, params):
    """(prefill logits and DEC_STEPS decode steps' logits, feeding the
    prompt's tokens; each layer kind's first cache at rest, its shapes)."""
    from repro_torch.models import model as M
    toks, img = _tokens(data["toks"]), _img(data, arch)
    with torch.no_grad():
        pre, cache = M.prefill(params, toks, cfg,
                               max_len=toks.shape[1] + DEC_STEPS,
                               image_embeds=img)
        steps = [pre]
        for s in range(DEC_STEPS):
            lg, cache = M.decode_step(
                params, cache, toks[:, s:s + 1],
                torch.full((toks.shape[0],), toks.shape[1] + s), cfg)
            steps.append(lg)
    shapes = {}
    for i, lc in enumerate(cache):
        kind = ("ssm" if M.layer_spec(cfg, i).kind == "ssm" else "cross"
                if M.layer_spec(cfg, i).cross_attn else "self")
        leaves = lc if kind == "ssm" else (lc["k"], lc["v"])
        shapes.setdefault(kind, [tuple(t.shape) for t in leaves])
    return [t.numpy() for t in steps], shapes


def _operands(run):
    """(``run()``, the uint8 activation operand of every lut_matmul it
    launches, in order, with the rank's (data, model) coordinates)."""
    from repro_torch.kernels import ops
    from repro_torch.parallel import ctx
    real, seen = ops.lut_matmul, []

    def rec(a, b, lut):
        seen.append(a.numpy().copy())
        return real(a, b, lut)
    ops.lut_matmul = rec
    try:
        out = run()
    finally:
        ops.lut_matmul = real
    mesh = ctx.get_mesh()
    at = (0, 0) if mesh is None else (mesh.axis_index("data"),
                                      mesh.axis_index("model"))
    return out, seen, at


def _lut_serve(data, arch):
    from repro_torch.models import quant
    cfg = _cfg(arch, approx_matmul=True)
    quant.set_multiplier_lut(_lut())
    try:
        return _operands(lambda: _serve(data, arch, cfg,
                                        _params(data, arch, cfg))[0])
    finally:
        quant.set_multiplier_lut(None)


def _flops(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _mixer_flops(data, arch, layer):
    """The matmul FLOPs of layer ``layer``'s mixer block on the active
    mesh, from the tokens' worth of activations (4 x 12 rows)."""
    from repro_torch.models import model as M
    cfg = _cfg(arch)
    params = _params(data, arch, cfg)
    x = torch.randn(TOKS + (cfg.d_model,),
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        return _flops(lambda: M._mixer_block(
            M.layer_spec(cfg, layer), params.layers[layer], x, cfg,
            _img(data, arch)))


def _blocks(data, arch):
    """Each SSM and cross-attention call's "tp" axes and the shape of its
    first column-parallel weight in the compute, over one forward."""
    from repro_torch.models import attention as A
    from repro_torch.models import ssm as S
    cfg = _cfg(arch)
    seen = []
    real = S.ssm_forward, A.cross_attention

    def ssm(params, x, cfg_, *a, tp=(), **kw):
        seen.append(("ssm", tp, tuple(params.w_z.shape)))
        return real[0](params, x, cfg_, *a, tp=tp, **kw)

    def cross(params, x, kv, cfg_, *a, tp=(), **kw):
        seen.append(("cross", tp, tuple(params.wq.shape)))
        return real[1](params, x, kv, cfg_, *a, tp=tp, **kw)
    S.ssm_forward, A.cross_attention = ssm, cross
    try:
        with torch.no_grad():
            from repro_torch.models import model as M
            M.forward_train(_params(data, arch, cfg), _tokens(data["toks"]),
                            cfg, _img(data, arch))
    finally:
        S.ssm_forward, A.cross_attention = real
    return seen


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


def _model_gathers(data, arch):
    """The all-gathers over "model" alone of a forward and of a training
    step's loss and gradients."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import model as M
    cfg = _cfg(arch)
    toks, tgt, img = (_tokens(data["toks"]), _tokens(data["tgt"]),
                      _img(data, arch))
    params = _params(data, arch, cfg)
    with torch.no_grad():
        _, fw = _gathers(lambda: M.forward_train(params, toks, cfg, img))
    params = _params(data, arch, cfg)
    _, train = _gathers(lambda: ST.loss_and_grads(params, cfg, toks, tgt,
                                                  image_embeds=img))
    model = lambda seen: [g for g in seen if g[0] == ("model",)]
    return model(fw), model(train)


def _world(rank, world, data, archs):
    """Every run of this world: the unsharded one on a world of 1; (1, 2)
    on 2 ranks; (1, 4) and (2, 2) on 4."""
    from repro_torch.parallel import ctx
    shapes = {1: (None,), 2: ((1, 2),), 4: ((1, 4), (2, 2))}[world]
    out = {}
    for shape in shapes:
        with ctx.use_mesh(_mesh(shape)):
            for arch in archs:
                cfg = _cfg(arch)
                r = _grads_and_train(data, arch)
                r["serve"] = _serve(data, arch, cfg,
                                    _params(data, arch, cfg))
                r["lut"] = _lut_serve(data, arch)
                if shape is None or shape[0] == 1:
                    r["flops"] = [_mixer_flops(data, arch, i)
                                  for i in range(len(cfg.period))]
                    r["blocks"] = _blocks(data, arch)
                if shape == (1, 2):
                    r["gathers"] = _model_gathers(data, arch)
                if shape is None or shape[0] == 1:
                    r["remat"] = _remat_grads(data, arch)
                out[(arch, shape)] = r
    return out


def _whole_function(arch, shape):
    """False where the sharded run is another function than the unsharded
    one: jamba's expert-parallel MoE over a dp-split batch takes its
    load-balancing aux loss from each dp row block's routing (ROADMAP,
    facts about the reference, 3), in both packages."""
    return not (arch == "jamba_1_5_large_398b" and shape[0] > 1)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _outs(ports, shape):
    one, two, four = ports
    return two if shape == (1, 2) else four


# ---------------------------------------------------------------------------
# the checks, by (arch, shape) (``tests/test_torch_tensor_parallel_hybrid.py``
# runs them on jamba)
# ---------------------------------------------------------------------------

def check_forward_and_gradients_against_reference(runs, arch, shape):
    """Forward logits and the gradient of every leaf (``w_bc``,
    ``conv_bc_w``, the norms, ``gate_norm`` and the cross gates included),
    gathered whole on every rank, within the float32 tolerance of the
    reference's GSPMD run on the same mesh and of the port's unsharded
    run (jamba over a dp split: its gradients, of another function, the
    reference's alone); the clip's norm, taken on the slices, the
    unsharded one (the replicated leaves' gradients, equal on every rank,
    counted once)."""
    ref, ports = runs
    want, whole = ref[(arch, shape)], ports[0][(arch, None)]
    same = _whole_function(arch, shape)
    from repro_torch import tree as T
    ref_grads = [np.asarray(g) for g in T.leaves(want["grads"])]
    for out in _outs(ports, shape):
        got = out[(arch, shape)]
        _close(got["fw"], want["fw"])
        _close(got["fw"], whole["fw"])
        assert len(got["grads"]) == len(ref_grads)
        for g, r, w in zip(got["grads"], ref_grads, whole["grads"]):
            _close(g, r)
            if same:
                _close(g, w)
        if same:
            np.testing.assert_allclose(got["norm"], whole["norm"],
                                       rtol=LOSS_RTOL)


def check_training_against_reference(runs, arch, shape):
    """3 AdamW steps: losses within LOSS_RTOL and parameters within the
    float32 tolerance of the reference's sharded steps and the port's
    unsharded ones.  jamba over a dp split: the reference's alone, its
    losses shifted by 0.01 x (the dp row blocks' mean aux - the first
    block's), since it reports device 0's aux and the port the mean both
    packages differentiate (as ``tests/test_torch_parallel_lm.py``)."""
    ref, ports = runs
    want, whole = ref[(arch, shape)], ports[0][(arch, None)]
    same = _whole_function(arch, shape)
    losses = np.array(want["losses"])
    if want["row_aux"] is not None:
        rows = np.array(want["row_aux"])
        shift = 0.01 * (rows.mean(1) - rows[:, 0])
        losses = losses + shift
    from repro_torch import tree as T
    ref_params = [np.asarray(p) for p in T.leaves(want["params"])]
    for out in _outs(ports, shape):
        got = out[(arch, shape)]
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_RTOL)
        if same:
            np.testing.assert_allclose(got["losses"], whole["losses"],
                                       rtol=LOSS_RTOL)
        for p, r, w in zip(got["params"], ref_params, whole["params"]):
            _close(p, r)
            if same:
                _close(p, w)


# each layer kind's cache at rest a rank: the SSM state's conv_x channels
# and heads split over "model", conv_bc whole; the cross K/V heads-split at
# tp = 2, head_dim-split at tp = 4 (2 kv heads), the batch over "data"
REST = {
    ("mamba2_1_3b", (1, 2)): {"ssm": [(4, 3, 64), (4, 3, 32),
                                      (4, 4, 16, 16)]},
    ("mamba2_1_3b", (1, 4)): {"ssm": [(4, 3, 32), (4, 3, 32),
                                      (4, 2, 16, 16)]},
    ("mamba2_1_3b", (2, 2)): {"ssm": [(4, 3, 64), (4, 3, 32),
                                      (4, 4, 16, 16)]},
    ("llama3_2_vision_11b", (1, 2)): {"cross": [(4, 16, 1, 16)] * 2},
    ("llama3_2_vision_11b", (1, 4)): {"cross": [(4, 16, 2, 4)] * 2},
    ("llama3_2_vision_11b", (2, 2)): {"cross": [(2, 16, 1, 16)] * 2},
}


def check_decode_on_split_state(runs, arch, shape):
    """The prefill and DEC_STEPS decode steps over the split SSM state and
    the split cross K/V cache: each rank's caches at rest have the
    reference's shard shapes (``REST``), its logits are the unsharded
    run's within the float32 tolerance."""
    _, ports = runs
    want = ports[0][(arch, None)]["serve"][0]
    for out in _outs(ports, shape):
        logits, rest = out[(arch, shape)]["serve"]
        for kind, shapes in REST.get((arch, shape), {}).items():
            assert rest[kind] == shapes, (kind, rest[kind])
        for a, b in zip(logits, want):
            _close(a, b)


def _first_split(got, want, at, shape):
    """The first uint8 operand where a rank's run at mesh coordinates
    ``at`` of ``shape`` and the unsharded run part: (index, largest step,
    share of the rank's block that differs), or None."""
    for i, (g, w) in enumerate(zip(got, want)):
        rows = g.shape[0]
        w = w[at[0] * rows:(at[0] + 1) * rows] if rows != w.shape[0] else w
        if g.shape[1] != w.shape[1]:       # a row-parallel projection
            k = g.shape[1]
            w = w[:, at[1] * k:(at[1] + 1) * k]
        if not np.array_equal(g, w):
            return (i, int(np.abs(g.astype(int) - w).max()),
                    float((g != w).mean()))
    return None


def check_lut_logits_against_one_rank(runs, arch, shape):
    """On the approximate multiplier (a random product table) each rank
    launches as many contractions as one rank, on its block of one rank's
    uint8 operands.  Where every operand equals one rank's, the prefill
    and decode logits are one rank's: bit for bit on the vision model on
    (1, 2) (its ranges and int32 sums the whole tensors', every head's
    float work the same), within the float32 tolerance elsewhere (the SSD
    scan over a rank's heads, a shared kv head's grouping and a dp split
    round otherwise, and so may a range's last bit).  Where one differs
    (the SSM's gate norm, summed over "tp" in another order) it is one
    step apart in at most Q_FLIP_FRACTION of it."""
    _, ports = runs
    (want, want_ops, _) = ports[0][(arch, None)]["lut"]
    for out in _outs(ports, shape):
        logits, ops, at = out[(arch, shape)]["lut"]
        assert len(ops) == len(want_ops)
        split = _first_split(ops, want_ops, at, shape)
        if split is None:
            for a, b in zip(logits, want):
                if arch == "llama3_2_vision_11b" and shape == (1, 2):
                    assert np.array_equal(a, b)
                else:
                    _close(a, b)
        else:
            assert arch != "llama3_2_vision_11b", split
            assert split[1] == 1 and split[2] <= Q_FLIP_FRACTION, split


def _bc_flops(cfg):
    """The FLOPs of the whole B / C projection at the tokens' rows."""
    G, N = cfg.ssm.n_groups, cfg.ssm.d_state
    return 2 * TOKS[0] * TOKS[1] * cfg.d_model * 2 * G * N


def _kv_flops(cfg, rows):
    """The FLOPs of the whole K / V projections of ``rows`` rows."""
    return 2 * 2 * rows * cfg.d_model * cfg.n_kv_heads * cfg.hd


def check_mixer_flops_split_over_tp(runs, arch, shape):
    """FlopCounterMode on a (1, tp) rank, each period slot's mixer block:
    an SSM mixer's matmul FLOPs are one rank's over tp but the whole B / C
    projection's, which every rank computes; a cross block's are one
    rank's over tp where the kv heads divide (tp = 2), and at tp = 4 (the
    kv head a rank's query heads share) all but the K / V projections',
    which are the shared head's: a kv-th of the whole; self-attention
    blocks (jamba's and the vision model's) the same."""
    _, ports = runs
    tp = shape[1]
    cfg = _cfg(arch)
    whole = ports[0][(arch, None)]["flops"]
    for out in _outs(ports, shape):
        got = out[(arch, shape)]["flops"]
        for spec, g, w in zip(cfg.period, got, whole):
            if spec.kind == "ssm":
                bc = _bc_flops(cfg)
                assert (g - bc) * tp == w - bc
            elif tp > cfg.n_kv_heads:
                kv = _kv_flops(cfg, TOKS[0] * (cfg.n_img_tokens
                                               if spec.cross_attn
                                               else TOKS[1]))
                assert (g - kv // cfg.n_kv_heads) * tp == w - kv
            else:
                assert g * tp == w


def check_ssm_and_cross_blocks_split(runs, arch):
    """Which SSM and cross blocks split: on (1, 2) and (1, 4) each runs
    with "model" as its tp axes and the rank's columns of ``w_z`` / ``wq``;
    unsharded, no axes and the whole weight."""
    _, ports = runs
    one = ports[0][(arch, None)]["blocks"]
    assert one and all(tp == () for _, tp, _ in one)
    for shape in ((1, 2), (1, 4)):
        n = shape[1]
        for out in _outs(ports, shape):
            got = out[(arch, shape)]["blocks"]
            assert [k for k, _, _ in got] == [k for k, _, _ in one]
            for (_, tp, w), (_, _, w1) in zip(got, one):
                assert tp == ("model",)
                assert w == (w1[0], w1[1] // n)


def check_no_weight_gather_in_an_ssm_or_cross_block(runs, arch):
    """On (1, 2) no weight is gathered over "model": the forward's one
    all-gather over it is the logits' (their vocabulary columns), the
    training step's loss (vocab-parallel) and backward issue none, as in
    a dense block (``tests/test_torch_tensor_parallel.py``)."""
    _, ports = runs
    cfg = _cfg(arch)
    for out in ports[1]:
        fw, train = out[(arch, (1, 2))]["gathers"]
        assert fw == [(("model",), TOKS + (cfg.vocab // 2,), -1)]
        assert train == []


def check_remat_and_chunked_loss(runs, arch, shape):
    """With each layer recomputed in the backward pass and the loss in
    sequence chunks (the full configurations' training), the loss on a
    (1, tp) mesh is the unsharded one within LOSS_RTOL and every leaf's
    gradient within the float32 tolerance: the recompute issues the
    split blocks' collectives again and the replicated leaves' gradients
    stay whole."""
    _, ports = runs
    w_loss, w_grads = ports[0][(arch, None)]["remat"]
    for out in _outs(ports, shape):
        loss, grads = out[(arch, shape)]["remat"]
        np.testing.assert_allclose(loss, w_loss, rtol=LOSS_RTOL)
        for g, w in zip(grads, w_grads):
            _close(g, w)


# ---------------------------------------------------------------------------
# the tests: mamba2 and the vision model (jamba's are
# ``tests/test_torch_tensor_parallel_hybrid.py``)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CASES)
def test_forward_and_gradients_against_reference(runs, arch, shape):
    check_forward_and_gradients_against_reference(runs, arch, shape)


@pytest.mark.parametrize("arch,shape", CASES)
def test_training_against_reference(runs, arch, shape):
    check_training_against_reference(runs, arch, shape)


@pytest.mark.parametrize("arch,shape", CASES)
def test_decode_on_split_state(runs, arch, shape):
    check_decode_on_split_state(runs, arch, shape)


@pytest.mark.parametrize("arch,shape", CASES)
def test_lut_logits_against_one_rank(runs, arch, shape):
    check_lut_logits_against_one_rank(runs, arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_mixer_flops_split_over_tp(runs, arch, shape):
    check_mixer_flops_split_over_tp(runs, arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_and_cross_blocks_split(runs, arch):
    check_ssm_and_cross_blocks_split(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_no_weight_gather_in_an_ssm_or_cross_block(runs, arch):
    check_no_weight_gather_in_an_ssm_or_cross_block(runs, arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_remat_and_chunked_loss(runs, arch, shape):
    check_remat_and_chunked_loss(runs, arch, shape)
