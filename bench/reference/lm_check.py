"""The judge of one call of the LM (a forward or a decode step), operation
by operation from the program's own state.

On an approximate multiplier the product table is discontinuous: a
rounding that moves one uint8 operand a step can move a product by the
multiplier's worst error, so two correct computations that round
differently drift apart over the depth of the model.  So each operation
is judged from the inputs the program gave it, as captured during the
call: the embedding from the tokens; in each layer the norms, every
projection (its products through the table, exactly, on a sample of
rows; the scale is the whole tensor's), rotary embedding with attention
(over the program's own cache in a decode step, and the key and value the
step wrote there), the residual additions, the gated MLP's product; and
the head from the program's last hidden state, judged by the served
tokens or the loss.  Each operation is one operation deep, so a fault in
any of them shows, and none drifts.

``capture`` is the format: ``tokens`` (B, S), ``pos`` (S,) positions of
the rows, ``events``: the call's RMS norms and projections as ("norm" or
"proj", input, output) in the order it made them, and for a decode step
``cache``: per layer (k, v) of positions 0..pos, as the program holds
them after the step.  The order is the configuration's (``LAYER`` for
each of its ``num_hidden_layers`` layers, then the final norm), and so is
each projection's input and output width; q, k and v read the attention
norm's output and the MLP's up and gate projections the MLP norm's, the
very tensors.  ``wiring`` counts the calls out of place and the links
broken: a layer left out or a projection fed another activation reads
above 0.  Each block's input is the residual stream the block before it
left, so each residual addition (a ``block_gap``) ties a layer to the
next, and the head reads what the last layer left.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference import lm as REF


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 error."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


class _Side:
    """What is judged: the program's captured outputs (``model`` None), or
    a model's outputs from the same inputs (the control)."""

    def __init__(self, model):
        self.m = model

    def out(self, captured, fn, *inputs):
        if self.m is None:
            return captured
        r = self.m.rnd
        return fn(self.m, *(r(x.to(torch.float32)) for x in inputs))


ATTN = ("wq", "wk", "wv", "wo")
FFN = ("w_up", "w_gate", "w_down")
# one layer's calls in the configuration's order: the attention norm, q,
# k, v, o, the MLP's norm, its up, gate and down projections
LAYER = ("norm",) + ATTN + ("norm",) + FFN
READS_NORM = (("wq", 0), ("wk", 0), ("wv", 0), ("w_up", 1), ("w_gate", 1))


def widths(s: dict) -> dict:
    """(input, output) width of each projection."""
    d, hd, f = s["hidden_size"], s["head_dim"], s["intermediate_size"]
    q, kv = s["num_attention_heads"] * hd, s["num_key_value_heads"] * hd
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "w_up": (d, f), "w_gate": (d, f), "w_down": (f, d)}


def layers_of(events: list, s: dict) -> tuple[list, tuple, int]:
    """(layers, final, wiring): the events as ``num_hidden_layers``
    layers, each {"norm": [(x, y) of the attention norm, of the MLP norm],
    "proj": {name: (x, y)}}, and the final norm's (x, y); and the number
    of calls out of place or of the wrong width, and of projections that
    do not read their norm's output.  Layers and final None where wiring
    is not 0."""
    kinds = ["norm" if k == "norm" else "proj" for k in LAYER]
    want = kinds * s["num_hidden_layers"] + ["norm"]
    got = [e[0] for e in events]
    bad = sum(a != b for a, b in zip(got, want)) + abs(len(got) - len(want))
    wid = widths(s)
    layers = []
    for i in range(s["num_hidden_layers"] if not bad else 0):
        ev = events[i * len(LAYER):(i + 1) * len(LAYER)]
        norms = [e[1:] for e in ev if e[0] == "norm"]
        proj = {k: e[1:] for k, e in zip(LAYER, ev) if k != "norm"}
        bad += sum((x.shape[-1], y.shape[-1]) != wid[k]
                   for k, (x, y) in proj.items())
        bad += sum(not torch.equal(proj[k][0], norms[n][1])
                   for k, n in READS_NORM)
        layers.append({"norm": norms, "proj": proj})
    if bad:
        return None, None, bad
    return layers, events[-1][1:], 0


def judge(ref: REF.Model, cap: dict, rows: torch.Tensor, control=None,
          targets: torch.Tensor | None = None,
          served: torch.Tensor | None = None,
          loss: float | None = None) -> dict:
    """The numbers compared: ``wiring`` (calls out of place, links
    broken; the others are left out where the calls are not the
    configuration's), ``proj_gap`` (worst projection), ``block_gap``
    (worst other operation), ``kv_gap`` (a decode step's cache writes),
    and ``token_gap`` (served tokens' logits below the best, beyond one
    bfloat16 step) or
    ``loss_gap``.  ``control``: judge that model in the program's place
    (serving what its own whole step puts first)."""
    side = _Side(control)
    s = ref.s
    eps, theta = s["rms_norm_eps"], s["rope_theta"]
    f32 = lambda t: t.to(torch.float32)
    gaps = {"proj_gap": 0.0, "block_gap": 0.0}
    note = lambda k, v: gaps.__setitem__(k, max(gaps.get(k, 0.0), v))

    def norm(m, x):
        return m.rnd(REF.rms_norm(x, eps))

    def residual(m, x, y):
        return m.rnd(x + y)

    def gate(m, g, u):
        return m.rnd(m.rnd(F.silu(g)) * u)

    layers, final, wiring = layers_of(cap["events"], s)
    if wiring:
        return {"wiring": float(wiring)}
    gaps["wiring"] = 0.0
    # the residual stream before each block, and after the last
    stream = [n[0] for layer in layers for n in layer["norm"]] + [final[0]]
    tok = cap["tokens"]
    want = ref.rnd(ref.embed()[tok])
    note("block_gap", rel(side.out(stream[0], lambda m, t: m.rnd(
        m.embed()[tok]), want), want))
    for i, layer in enumerate(layers):
        proj = layer["proj"]
        for name, (x, y) in proj.items():
            wi = ref.weight(i, name)
            want = ref.rnd(REF.approx_linear(f32(x), wi, ref.table, rows))
            got = side.out(f32(y).reshape(-1, y.shape[-1])[rows],
                           lambda m, xx: m.rnd(REF.approx_linear(
                               xx, m.weight(i, name), m.table, rows)), x)
            note("proj_gap", rel(got, want))
        for b, w_out in enumerate(("wo", "w_down")):
            x_in, h = layer["norm"][b]
            x_out = stream[2 * i + b + 1]
            want = norm(ref, f32(x_in))
            note("block_gap", rel(side.out(h, norm, x_in), want))
            want = residual(ref, f32(x_in), f32(proj[w_out][1]))
            note("block_gap", rel(side.out(x_out, residual, x_in,
                                           proj[w_out][1]), want))
        yg, yu = proj["w_gate"][1], proj["w_up"][1]
        want = gate(ref, f32(yg), f32(yu))
        note("block_gap", rel(side.out(proj["w_down"][0], gate, yg, yu),
                              want))
        B, S = tok.shape
        hd = s["head_dim"]
        heads = lambda t: f32(t).reshape(B, S, -1, hd)
        pos = cap["pos"].expand(B, S)
        rope = lambda m, t: m.rnd(REF.rope(heads(t), pos, theta))
        q = rope(ref, proj["wq"][1])
        k = rope(ref, proj["wk"][1])
        v = heads(proj["wv"][1])
        if "cache" in cap:
            ck, cv = (f32(t) for t in cap["cache"][i])
            p = int(cap["pos"][-1])
            note("kv_gap", rel(side.out(ck[:, p:p + 1], rope, proj["wk"][1]),
                               k))
            note("kv_gap", rel(side.out(cv[:, p:p + 1], lambda m, t: heads(t),
                                        proj["wv"][1]), v))
            keys, vals = ck, cv
        else:
            keys, vals = k, v

        def attention(m, qq, kk, vv):
            return m.rnd(REF.attend(qq, kk, vv, cap["pos"])).reshape(B, S, -1)
        want = attention(ref, q, keys, vals)
        got = side.out(proj["wo"][0], lambda m, t, kk, vv: attention(
            m, rope(m, t), kk, vv), proj["wq"][1], keys, vals)
        note("block_gap", rel(got, want))

    x_f, h_f = final
    note("block_gap", rel(side.out(h_f, norm, x_f), norm(ref, f32(x_f))))
    last = f32(x_f)
    table = ref.embed()
    logits = ref.rnd(ref.rnd(REF.rms_norm(last, eps)) @ table.T)
    if served is not None:
        if control is None:
            pick = served
        else:
            # the control serves what its own whole step puts first, from
            # the same tokens and the program's cache
            past = lambda i: tuple(f32(t)[:, :-1] for t in cap["cache"][i])
            h, _ = control.run(tok, cap["pos"].expand(B, S), past)
            pick = control.logits(h)[:, -1].argmax(-1)
        lg = logits[:, -1]
        best = lg.max(-1).values
        # the logits are bfloat16: a token within one step of the best
        # (2^-7 of its power of two) may be first after either rounding
        step = torch.ldexp(torch.ones_like(best), torch.frexp(best)[1] - 8)
        below = best - lg.gather(1, pick[:, None])[:, 0] - step
        gaps["token_gap"] = float(below.clamp_min(0).max())
    if targets is not None:
        ce = lambda lg: float((lg.double().logsumexp(-1) - lg.double().gather(
            -1, targets[..., None])[..., 0]).mean())
        if control is None:
            got = loss
        else:
            r = control.rnd
            got = ce(r(r(REF.rms_norm(r(last), eps)) @ control.embed().T))
        gaps["loss_gap"] = abs(got - ce(logits))
    return gaps
