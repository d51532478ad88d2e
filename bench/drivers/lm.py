"""What the LM drivers share: the configuration mapped onto the program's,
the weights and the multiplier's table made from the seed, and the
reference model over the same buffers.

Weights are made on the device in the type they are served in, one
``normal_`` call for each group of projections with one standard
deviation (N(0, 1/d_in)) and one for the token table (N(0, 0.02²)); the
program's parameters and the reference's accessor are views of the same
buffers, which the reference makes anew from the seed after the program
is freed.  The norms' scales are one.
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from bench import harness as H
from bench import seeds
from bench.reference import circuit as C
from bench.reference import lm as REF

PROJ = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
MIXER = ("wq", "wk", "wv", "wo")


def sizes(config: dict) -> dict:
    """The configuration's sizes, head_dim derived where not given."""
    s = dict(config)
    s.setdefault("head_dim", s["hidden_size"] // s["num_attention_heads"])
    return s


def program_config(config: dict):
    """The program's ``ModelConfig`` of the configuration file: its
    ``program`` entry names the port's architecture and the fields set for
    the run; every size must be the file's."""
    from repro_torch.configs import base as B
    prog = config["program"]
    arch = B.get_arch(prog["arch"])
    base = arch.reduced() if prog.get("preset") == "reduced" else arch.CONFIG
    cfg = dataclasses.replace(base, **prog.get("fields", {}))
    s = sizes(config)
    want = {"d_model": s["hidden_size"], "n_heads": s["num_attention_heads"],
            "n_kv_heads": s["num_key_value_heads"], "hd": s["head_dim"],
            "d_ff": s["intermediate_size"], "vocab": s["vocab_size"],
            "n_layers": s["num_hidden_layers"], "rope_theta": s["rope_theta"],
            "norm_eps": s["rms_norm_eps"],
            "tie_embeddings": s["tie_word_embeddings"]}
    got = {k: getattr(cfg, k) for k in want}
    if got != want:
        raise ValueError(f"the program's {prog['arch']} is not the "
                         f"configuration: {got} != {want}")
    return cfg


def shapes(s: dict) -> dict:
    """(d_in, d_out) of each projection."""
    d, hd, f = s["hidden_size"], s["head_dim"], s["intermediate_size"]
    q, kv = s["num_attention_heads"] * hd, s["num_key_value_heads"] * hd
    return {"wq": (d, q), "wk": (d, kv), "wv": (d, kv), "wo": (q, d),
            "w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


class Weights:
    """The seeded weight buffers and views of them."""

    def __init__(self, s: dict, seed: int, device):
        shp = shapes(s)
        L = s["num_hidden_layers"]
        groups: dict[int, list] = {}
        for n in PROJ:
            groups.setdefault(shp[n][0], []).append(n)
        self.views = {}
        for d_in, names in sorted(groups.items()):
            n = L * sum(math.prod(shp[k]) for k in names)
            buf = torch.empty(n, dtype=torch.bfloat16, device=device)
            buf.normal_(0.0, d_in ** -0.5,
                        generator=seeds.torch_generator(seed, device,
                                                        "weights", d_in))
            off = 0
            for i in range(L):
                for k in names:
                    m = math.prod(shp[k])
                    self.views[(i, k)] = buf[off:off + m].view(shp[k])
                    off += m
        self.table = torch.empty((s["vocab_size"], s["hidden_size"]),
                                 dtype=torch.bfloat16, device=device)
        self.table.normal_(0.0, 0.02, generator=seeds.torch_generator(
            seed, device, "embedding"))

    def weight(self, i: int, name: str) -> torch.Tensor:
        return self.views[(i, name)]


def program_model(cfg, w: Weights, device):
    """The program's ``Transformer`` over the weight buffers, loaded with
    PyTorch's ``load_state_dict`` (strict: a parameter the program adds,
    drops or renames fails the load, not the check)."""
    from repro_torch.models import model as M
    ones = torch.ones(cfg.d_model, dtype=torch.bfloat16, device=device)
    state = {"embed.tokens": w.table, "final_norm": ones}
    for i in range(cfg.n_layers):
        for name in PROJ:
            owner = "mixer" if name in MIXER else "ffn"
            state[f"layers.{i}.{owner}.{name}"] = w.weight(i, name)
        state[f"layers.{i}.mixer.norm"] = ones
        state[f"layers.{i}.ffn.norm"] = ones
    params = M.skeleton(cfg, "meta")
    params.load_state_dict(state, strict=True, assign=True)
    return params.requires_grad_(False)


def multiplier_genome(config_root, cell: H.Cell, seed: int, device):
    """(nodes, outs, reference Problem on the CPU) of the run's
    approximate multiplier: the circuit configuration's golden genome
    under point mutations drawn from the seed, 64 candidates at a time
    evaluated on ``device``, the first whose mean error is above 0 and
    whose mean and worst errors are within the configuration's bounds (in
    % of its output range) taken.  No mutations: the exact multiplier."""
    spec = cell.config["multiplier"]
    with open(config_root / spec["circuit"]) as f:
        circuit = json.load(f)
    problem = C.Problem(circuit, "cpu")
    nodes0, outs0 = problem.golden_genome()
    if spec["mutations"] == 0:
        return nodes0, outs0, problem
    judge = C.Problem(circuit, device)
    r = seeds.rng(seed, "multiplier")
    for _ in range(16):
        cands = np.repeat(nodes0[None], 64, 0)
        for c in cands:
            for _ in range(spec["mutations"]):
                k = int(r.integers(problem.n_n))
                g = int(r.integers(3))
                hi = problem.n_i + k if g < 2 else problem.n_funcs
                c[k, g] = r.integers(hi)
        mets = judge.evaluate(cands, np.repeat(outs0[None], 64, 0))[0]
        ok = ((mets[:, 0] > 0) & (mets[:, 0] <= spec["max_mae_pct"])
              & (mets[:, 1] <= spec["max_wce_pct"]))
        if ok.any():
            return cands[int(ok.argmax())], outs0, problem
    raise RuntimeError("no multiplier within the bounds in 1024 draws")


def install_table(nodes, outs, problem: C.Problem):
    """The program simulates the genome's product table and installs it."""
    from repro_torch.core.genome import CGPSpec, Genome
    from repro_torch.core.library import multiplier_lut
    from repro_torch.models import quant
    spec = CGPSpec(problem.n_i, problem.n_o, problem.n_n)
    g = Genome(torch.tensor(nodes, dtype=torch.int32),
               torch.tensor(outs, dtype=torch.int32))
    quant.set_multiplier_lut(multiplier_lut(g, spec))


def reference_model(s: dict, w: Weights, nodes, outs, problem: C.Problem,
                    device, rnd=REF.bf16) -> REF.Model:
    """The reference over the weight buffers, storing activations as the
    configuration does (bfloat16), or as ``rnd`` says."""
    table = torch.as_tensor(problem.table(nodes, outs), device=device)
    return REF.Model(s, w.weight, lambda: w.table, table, rnd)


class Program:
    """One LM cell's program and inputs, made from the seed: the sizes,
    the program's config, the multiplier (its genome, and its table
    installed by the program), the weight buffers and the program's
    ``Transformer`` over them."""

    def __init__(self, cell: H.Cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, seed, torch.device(device)
        self.s = sizes(cell.config)
        self.cfg = program_config(cell.config)
        self.nodes, self.outs, self.problem = multiplier_genome(
            cell.root, cell, seed, self.dev)
        install_table(self.nodes, self.outs, self.problem)
        self.w = Weights(self.s, seed, self.dev)
        self.params = program_model(self.cfg, self.w, self.dev)

    def check(self, capture: dict, n_rows: int, control: bool,
              loss: float | None = None, **head):
        """Frees the program, makes the reference anew from the seed and
        judges the captured call (``reference.lm_check``): (checks, the
        control's numbers or None)."""
        from bench.reference import lm_check as J
        self.params = self.w = None
        free(self.dev)
        no_tf32()
        w = Weights(self.s, self.seed, self.dev)
        ref = reference_model(self.s, w, self.nodes, self.outs,
                              self.problem, self.dev)
        limits = self.cell.params["limits"]
        rows = check_rows(self.seed, n_rows, self.cell.params["check_rows"],
                          self.dev)
        with torch.no_grad():
            got = J.judge(ref, capture, rows, loss=loss, **head)
            # a number the judge could not work out (the call's structure
            # is not the configuration's) reads as infinite
            checks = [H.Check(k, got.get(k, math.inf), limits[k])
                      for k in limits]
            low = None
            if control:
                fp8 = reference_model(self.s, w, self.nodes, self.outs,
                                      self.problem, self.dev, REF.fp8)
                low = J.judge(ref, capture, rows, control=fp8, **head)
        return checks, low


def free(device):
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def no_tf32():
    """Full float32 matmuls for the reference, whatever the process set."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def device_trace(prof, window_s, calls: dict, flops: float, dev) -> object:
    """The Trace of a profiled LM window, with the kernels' recorded work
    and the model FLOPs of the window."""
    from bench.trace import from_profiler
    t = from_profiler(prof, window_s)
    t.calls = calls
    t.info["model_flops"] = flops
    return t


def recorder(ops, calls: dict, lut_bound, flash_bound):
    """Wrappers of the program's ``lut_matmul`` and ``flash_attention``
    entry points that record each call's work-model bound."""
    def lut(fn):
        def inner(a, b, table):
            calls.setdefault("lut_matmul", []).append(
                lut_bound(a.shape[0], a.shape[1], b.shape[1]))
            return fn(a, b, table)
        return inner

    def flash(fn):
        def inner(q, k, v, causal=True):
            B, Hq, Sq, D = q.shape
            calls.setdefault("flash_attention", []).append(
                flash_bound(B, Hq, k.shape[1], Sq, k.shape[2], D,
                            q.element_size(), bool(causal)))
            return fn(q, k, v, causal=causal)
        return inner
    return {(ops, "lut_matmul"): lut, (ops, "flash_attention"): flash}


class Capture:
    """Captures one call of the program for ``reference.lm_check`` at two
    public functions of the port: every RMS norm (``models/layers.py``
    ``rms_norm``, in each module of the port that calls it) and every
    projection through the multiplier (``models/quant.py``
    ``approx_matmul``), each as ("norm" or "proj", its input, its output),
    in the order the call made them.  Nothing is named by the program's
    tensors: the judge reads the layers and each projection's role from
    that order, and holds the order to the configuration's."""

    def __init__(self):
        self.events = []

    def wraps(self) -> dict:
        import sys

        from repro_torch.models import layers, quant

        def record(kind):
            def wrap(fn):
                def inner(x, *a, **k):
                    y = fn(x, *a, **k)
                    self.events.append((kind, x, y))
                    return y
                return inner
            return wrap
        out = {(quant, "approx_matmul"): record("proj")}
        for name, mod in list(sys.modules.items()):
            if name.split(".")[0] == "repro_torch" and \
                    getattr(mod, "rms_norm", None) is layers.rms_norm:
                out[(mod, "rms_norm")] = record("norm")
        return out


def check_rows(seed: int, n_rows: int, sample: int, device):
    """The rows whose projections the check recomputes, drawn from the
    seed."""
    idx = seeds.rng(seed, "rows").choice(n_rows, size=min(sample, n_rows),
                                         replace=False)
    return torch.as_tensor(np.sort(idx), device=device)


def seeded_tokens(seed: int, device, vocab: int, shape, *tags):
    return torch.randint(vocab, shape, device=device,
                         generator=seeds.torch_generator(seed, device,
                                                         *tags))
