"""The port's cross-attention, front-end stubs and GELU MLP against the JAX
package, on the same numpy weights and inputs, on the CPU.

Cross-attention runs with its gate at GATE and random image embeddings:
the reference's zero gate (and the launchers' zero embeddings) make a cross
layer the identity, which no comparison could see.  Each of three mutants
of the port (a skipped cross block, the erf form of GELU, an audio serve
loop that records every codebook or feeds back one) must fail the checks
the port passes.  Tolerances are ``test_torch_configs``': float32 RTOL /
ATOL, loss LOSS_RTOL, gradients GRAD_RTOL of the leaf's largest |g|; the
flash path's plain version sums in another order than the reference's
interpret-mode kernel (PALLAS_ATOL, as ``test_torch_model``).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.launch import serve as j_serve
from repro.launch import steps as JST
from repro.models import attention as JA
from repro.models import layers as JLay
from repro.models import model as JM
from repro.optim import OptConfig as JOptConfig
from repro.optim import apply_gradients as j_apply_gradients
from repro.optim import init_opt_state as j_init_opt_state
from repro_torch import convert as C
from repro_torch import tree as T
from repro_torch.configs import base as TB
from repro_torch.launch import serve as t_serve
from repro_torch.launch import steps as ST
from repro_torch.models import attention as TA
from repro_torch.models import layers as TLay
from repro_torch.models import model as TM
from repro_torch.optim import OptConfig, apply_gradients, init_opt_state

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

RTOL, ATOL = 2e-5, 2e-6
PALLAS_ATOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
GATE = 0.5
VISION, AUDIO = "llama3_2_vision_11b", "musicgen_large"


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(JB.get_arch(arch).reduced(),
                               scan_layers=False, **kw)
    return jcfg, dataclasses.replace(TB.get_arch(arch).reduced(), **kw)


def _with_gate(jp, jcfg, gate=GATE):
    for i, spec in enumerate(jcfg.period):
        if spec.cross_attn:
            mix = jp["layers"][f"layer{i}"]["mixer"]
            mix["gate"] = jnp.full_like(mix["gate"], gate)
    return jp


def _cross_params(jcfg, tcfg):
    """One cross layer's parameters, the reference's with its gate at GATE,
    and the port's ``Attention`` holding the same values."""
    jp = JA.init_attention(jax.random.PRNGKey(3), jcfg, cross=True)
    assert float(jp["gate"]) == 0.0
    jp["gate"] = jnp.asarray(GATE, jp["gate"].dtype)
    tp = TA.Attention(tcfg, "cpu", cross=True)
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(torch.as_tensor(np.array(jp[name])))
    return jp, tp


# ------------------------------ cross-attention -----------------------------

@pytest.mark.parametrize("impl", ["blocked", "naive", "pallas"])
def test_cross_attention_from_embeds_and_cache(impl):
    """From the embeddings (prefill, 8 positions) and from the K/V cache
    (one decode position): out and (k, v) as the reference's, on each
    attention path (``pallas``: the reference's kernel in interpret mode,
    the port's plain version of the flash kernel)."""
    jcfg, tcfg = _cfgs(VISION, attn_impl=impl)
    jp, tp = _cross_params(jcfg, tcfg)
    x, img = _x((2, 8, jcfg.d_model), 1), _x((2, jcfg.n_img_tokens,
                                               jcfg.d_model), 2)
    want, (jk, jv) = JA.cross_attention(jp, jnp.asarray(x), jnp.asarray(img),
                                        jcfg)
    with torch.no_grad():
        got, (tk, tv) = TA.cross_attention(tp, torch.as_tensor(x),
                                           torch.as_tensor(img), tcfg)
    atol = PALLAS_ATOL if impl == "pallas" else ATOL
    _close(got, want, atol=atol)
    _close(tk, jk)
    _close(tv, jv)
    assert tk.shape == (2, jcfg.n_img_tokens, jcfg.n_kv_heads, jcfg.hd)
    # the block changed x: its gated output is not negligible
    assert float((got - torch.as_tensor(x)).abs().max()) > 0.1
    x1 = _x((2, 1, jcfg.d_model), 4)
    want1, kv1 = JA.cross_attention(jp, jnp.asarray(x1), None, jcfg,
                                    kv_cache=(jk, jv))
    with torch.no_grad():
        got1, (k1, v1) = TA.cross_attention(tp, torch.as_tensor(x1), None,
                                            tcfg, kv_cache=(tk, tv))
    _close(got1, want1, atol=atol)
    assert k1 is tk and v1 is tv


def test_pallas_raises_at_1600_image_tokens():
    """The full-size vision model's 1600 image tokens are not a multiple of
    min(128, 1600): the reference's flash kernel asserts and the port's
    raises, in a cross layer and through the port's prefill (layer 0 is a
    cross layer); 1536 tokens, the longest legal length below, run."""
    jcfg, tcfg = _cfgs(VISION, attn_impl="pallas", n_img_tokens=1600)
    jp, tp = _cross_params(jcfg, tcfg)
    x, img = _x((1, 4, jcfg.d_model), 1), _x((1, 1600, jcfg.d_model), 2)
    with pytest.raises(AssertionError):
        JA.cross_attention(jp, jnp.asarray(x), jnp.asarray(img), jcfg)
    with torch.no_grad(), pytest.raises(ValueError, match="Skv=1600"):
        TA.cross_attention(tp, torch.as_tensor(x), torch.as_tensor(img),
                           tcfg)
    params = TM.init_params(torch.Generator().manual_seed(0), tcfg)
    with pytest.raises(ValueError, match="Skv=1600"):
        TM.prefill(params, torch.zeros((1, 4), dtype=torch.int64), tcfg,
                   image_embeds=torch.as_tensor(img))
    blocked = dataclasses.replace(tcfg, attn_impl="blocked")
    logits, cache = TM.prefill(params, torch.zeros((1, 4), dtype=torch.int64),
                               blocked, image_embeds=torch.as_tensor(img))
    assert cache[0]["k"].shape == (1, 1600, tcfg.n_kv_heads, tcfg.hd)
    with torch.no_grad():
        out, _ = TA.cross_attention(tp, torch.as_tensor(x),
                                    torch.as_tensor(img[:, :1536]), tcfg)
    assert bool(torch.isfinite(out).all())


def _skip_cross(real):
    """A mutant of ``attention.cross_attention`` that computes K and V but
    leaves x as it is (the block skipped)."""
    return lambda p, x, kv, cfg, kv_cache=None, **kw: (
        x, real(p, x, kv, cfg, kv_cache, **kw)[1])


@pytest.mark.parametrize("gate", [GATE, 0.0])
def test_skipped_cross_block_fails(gate, monkeypatch):
    """The reduced vision model's forward against the reference's: within
    RTOL / ATOL; a port that skips the cross block is far outside them with
    the gate at GATE, and invisible at the reference's zero gate (why every
    test of the cross path sets a gate)."""
    jcfg, tcfg = _cfgs(VISION)
    jp = _with_gate(JM.init_params(jax.random.PRNGKey(0), jcfg), jcfg, gate)
    tp = C.model_params(jp, tcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 12),
                                             dtype=np.int32)
    img = _x((2, jcfg.n_img_tokens, jcfg.d_model), 2)
    want, _ = JM.forward_train(jp, jnp.asarray(toks), jcfg,
                               image_embeds=jnp.asarray(img))
    run = lambda: TM.forward_train(tp, torch.as_tensor(toks).long(), tcfg,
                                   torch.as_tensor(img))[0]
    with torch.no_grad():
        port = run()
        _close(port, want)
        monkeypatch.setattr(TM.A, "cross_attention",
                            _skip_cross(TA.cross_attention))
        mutant = run()
    apart = float(np.abs(mutant.numpy() - np.asarray(want)).max())
    if gate:
        assert apart > 100 * (ATOL + RTOL * np.abs(np.asarray(want)).max())
    else:
        assert torch.equal(mutant, port)


# ------------------------------- the GELU MLP -------------------------------

def _mlp_apart(fn=None):
    """The largest |port - reference| of the reduced musicgen's GELU MLP
    on inputs whose pre-activations reach |x| ~ 4 (where the tanh and erf
    forms of GELU part by ~5e-4), over RTOL·|want| + ATOL; ``fn``
    replaces ``layers.mlp``."""
    jcfg, tcfg = _cfgs(AUDIO)
    jp = JLay.init_mlp(jax.random.PRNGKey(4), jcfg)
    assert "w_gate" not in jp
    tp = TLay.MLP(tcfg, "cpu")
    assert not hasattr(tp, "w_gate")
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(torch.as_tensor(np.array(jp[name])))
    x = _x((2, 16, jcfg.d_model), 5, 2.0)
    want = np.asarray(JLay.mlp(jp, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = (fn or TLay.mlp)(tp, torch.as_tensor(x), tcfg).numpy()
    return float((np.abs(got - want) / (ATOL + RTOL * np.abs(want))).max())


def test_gelu_mlp_matches_reference_and_erf_fails():
    """``act="gelu"``: no w_gate, ``jax.nn.gelu``'s tanh form in float32
    (within the tolerance); the erf form, PyTorch's default, is not."""
    assert _mlp_apart() <= 1.0
    erf = lambda p, x, cfg: x + TLay.matmul(
        torch.nn.functional.gelu(TLay.matmul(
            TLay.rms_norm(x, p.norm, cfg.norm_eps), p.w_up, cfg)),
        p.w_down, cfg)
    assert _mlp_apart(erf) > 10.0


# ------------------------------ the audio stub ------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_audio_embedding_head_and_loss(dtype):
    """The (C, V, D) table summed over codebooks in order, in its own dtype
    (bit for bit), the (C, D, V) head's (B, S, C, V) logits, and the CE
    over every codebook, which ``loss_vocab_chunk`` leaves alone."""
    jcfg, tcfg = _cfgs(AUDIO, param_dtype=dtype, act_dtype=dtype)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = C.model_params(jp, tcfg)
    C_, V, D = jcfg.n_codebooks, jcfg.vocab, jcfg.d_model
    assert tp.embed.tokens.shape == (C_, V, D)
    assert tp.lm_head.shape == (C_, D, V)
    toks = np.random.default_rng(1).integers(0, V, (2, 8, C_),
                                             dtype=np.int32)
    want = np.asarray(JLay.embed_tokens(jp["embed"], jnp.asarray(toks),
                                        jcfg).astype(jnp.float32))
    got = TLay.embed_tokens(tp.embed, torch.as_tensor(toks).long(), tcfg)
    assert got.dtype == tcfg.adtype()
    assert np.array_equal(got.to(torch.float32).numpy(), want)
    if dtype != "float32":
        return
    x = _x((2, 8, D), 2)
    with torch.no_grad():
        logits = TM.logits_from_hidden(tp, torch.as_tensor(x), tcfg)
    assert logits.shape == (2, 8, C_, V)
    _close(logits, JM.logits_from_hidden(jp, jnp.asarray(x), jcfg))
    tgt = np.roll(toks, -1, axis=1)
    wl = float(JM.lm_loss(jp, jnp.asarray(toks), jnp.asarray(tgt), jcfg))
    for chunk in (0, 4):
        c = dataclasses.replace(tcfg, loss_vocab_chunk=chunk)
        with torch.no_grad():
            tl = float(TM.lm_loss(tp, torch.as_tensor(toks).long(),
                                  torch.as_tensor(tgt).long(), c))
        assert tl == pytest.approx(wl, rel=LOSS_RTOL)


def _serve_mutant(old: str, new: str):
    """``serve._serve_loop`` with one line of its source replaced."""
    src = inspect.getsource(t_serve._serve_loop)
    assert src.count(old) == 1, old
    ns = dict(vars(t_serve))
    exec(compile(src.replace(old, new), "<mutant>", "exec"), ns)
    return ns["_serve_loop"]


def test_audio_serve_matches_reference_and_mutants_fail():
    """The reduced musicgen's greedy serve loop: the reference's outputs
    (codebook 0 of each step, every codebook fed back); a loop recording
    all four codebooks, or feeding back codebook 0 alone, gives others."""
    jcfg, tcfg = _cfgs(AUDIO)
    tp = C.model_params(JM.init_params(jax.random.PRNGKey(0), jcfg), tcfg)
    args = (tcfg, tp, 3, 8, 6, 2, 0, "cpu")
    want = j_serve._serve_loop(jcfg, 3, 8, 6, 2, 0)["outputs"]
    want = {k: list(v) for k, v in want.items()}
    assert t_serve._serve_loop(*args)["outputs"] == want
    records_all = _serve_mutant(
        "r.out.append(int(next_np[i, 0]))",
        "r.out.extend(int(t) for t in next_np[i])")
    feeds_one = _serve_mutant(
        "M.decode_step(params, cache, next_tok[:, None],",
        "M.decode_step(params, cache, next_tok[:, None] * (torch.arange("
        "next_tok.shape[-1]) == 0),")
    for mutant in (records_all, feeds_one):
        assert mutant(*args)["outputs"] != want


# ---------------------------- shapes and training ---------------------------

@pytest.mark.parametrize("arch", JB.ARCH_IDS)
def test_input_specs_match_reference(arch):
    """Every (shape, dtype) of ``input_specs`` for each of the arch's shape
    cells, full size and with a batch override, is the reference's
    ``ShapeDtypeStruct``'s."""
    jcfg, tcfg = JB.get_arch(arch).CONFIG, TB.get_arch(arch).CONFIG
    cells = TB.shapes_for(arch)
    assert [s.name for s in cells] == [s.name for s in JB.shapes_for(arch)]
    jcells = {s.name: s for s in JB.shapes_for(arch)}
    for shape in cells:
        for override in (None, 3):
            got = TB.input_specs(tcfg, shape, override)
            want = JB.input_specs(jcfg, jcells[shape.name], override)
            assert set(got) == set(want), (arch, shape.name)
            for k, (shp, dt) in got.items():
                assert shp == want[k].shape, (arch, shape.name, k)
                assert str(dt).split(".")[-1] == str(want[k].dtype)


def test_cross_caches_and_gate_leaves_round_trip():
    """Two periods of the reduced vision model: the gate leaf is (2,) in
    the reference's tree and carries each period's own value both ways;
    ``init_cache`` gives the reference's cache shapes (cross layers' (B,
    n_img_tokens, Hkv, hd)); the 8-bit AdamW state of the gate leaf (a
    0-d scale) is the reference's, before and after a step."""
    jcfg, tcfg = _cfgs(VISION, n_layers=4)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    g = jp["layers"]["layer0"]["mixer"]["gate"]
    assert g.shape == (2,)
    jp["layers"]["layer0"]["mixer"]["gate"] = jnp.asarray([0.25, 0.75],
                                                          g.dtype)
    tp = C.model_params(jp, tcfg)
    assert [float(tp.layers[i].mixer.gate) for i in (0, 2)] == [0.25, 0.75]
    back = C.reference_params(tp, tcfg)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), b)
    jc = JM.init_cache(jcfg, 3, 10)
    tc = TM.init_cache(tcfg, 3, 10)
    assert tc[0]["k"].shape == (3, jcfg.n_img_tokens, jcfg.n_kv_heads,
                                jcfg.hd)
    assert [(a.shape, a.dtype) for a in jax.tree.leaves(jc)] == [
        (b.shape, b.dtype) for b in jax.tree.leaves(C.reference_cache(
            tc, tcfg))]
    gate = {"gate": jp["layers"]["layer0"]["mixer"]["gate"]}
    grad = {"gate": jnp.asarray([0.3, -0.2], jnp.float32)}
    jo, to = JOptConfig(name="adamw8bit"), OptConfig(name="adamw8bit")
    js = j_init_opt_state(gate, jo)
    tg = C.opt_state(gate)
    ts = init_opt_state(tg, to)
    assert ts["m"]["gate"]["s"].shape == () == js["m"]["gate"]["s"].shape
    jp2, js2 = j_apply_gradients(gate, grad, js, jnp.int32(0), jo)
    tp2, ts2 = apply_gradients(tg, C.opt_state(grad), ts, 0, to)
    for a, b in zip(jax.tree.leaves((jp2, js2)),
                    T.leaves(tp2) + T.leaves(ts2)):
        assert np.array_equal(np.asarray(a), C.to_host(b))


def test_microbatched_vision_training_keeps_the_reference_quirk():
    """With microbatches = 2 every slice gets the whole batch's image
    embeddings, as in the reference: a slice's 2 rows each attend to 2
    images (K/V reshaped to (2, 2·n_img_tokens, Hkv, hd)).  The port's
    loss is the reference's train step's, its gradients the reference's
    accumulation; both differ from one microbatch's."""
    jcfg, tcfg = _cfgs(VISION)
    jp = _with_gate(JM.init_params(jax.random.PRNGKey(0), jcfg), jcfg)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, jcfg.vocab, (4, 16), dtype=np.int32)
    tgt = np.roll(toks, -1, axis=1)
    img = _x((4, jcfg.n_img_tokens, jcfg.d_model), 7)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt),
          "image_embeds": jnp.asarray(img)}
    step = JST.make_train_step(jcfg, JOptConfig(), microbatches=2)
    _, _, jm = step(jp, j_init_opt_state(jp, JOptConfig()), jb,
                    jnp.int32(0))

    def j_grads(rows):
        return jax.value_and_grad(lambda p: JM.lm_loss(
            p, jb["tokens"][rows], jb["targets"][rows], jcfg,
            image_embeds=jb["image_embeds"]))(jp)

    parts = [j_grads(slice(0, 2)), j_grads(slice(2, 4))]
    jg = jax.tree.map(lambda a, b: (a + b) / 2, parts[0][1], parts[1][1])
    tt = lambda a: torch.as_tensor(a).long()
    tp = C.model_params(jp, tcfg)
    loss, tg = ST.loss_and_grads(tp, tcfg, tt(toks), tt(tgt), 2,
                                 torch.as_tensor(img))
    assert float(loss) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
    for a, b in zip(jax.tree.leaves(jg), T.leaves(tg)):
        a = np.asarray(a)
        np.testing.assert_allclose(C.to_host(b), a, rtol=0,
                                   atol=GRAD_RTOL * np.abs(a).max())
    one, _ = ST.loss_and_grads(C.model_params(jp, tcfg), tcfg, tt(toks),
                               tt(tgt), 1, torch.as_tensor(img))
    assert abs(float(one) - float(loss)) > 1e-4
    with torch.no_grad():
        _, (k, _) = TA.cross_attention(
            tp.layers[0].mixer, torch.zeros((2, 16, jcfg.d_model)),
            torch.as_tensor(img), tcfg)
    assert k.shape == (2, 2 * jcfg.n_img_tokens, jcfg.n_kv_heads, jcfg.hd)
