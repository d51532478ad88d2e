"""The check's own test: a run with the timed path broken underneath, and
the control put in the program's place, must come out not correct, while
a sound run comes out correct (``test_bench_discovery``).  Tiny cells on
the CPU; the harness's look for a card is skipped (``harness.run``).  One
test for each fault a cell can have: the evaluation's batch is one
sequence, so it has no half to leave out, and no state to leave
unchanged."""
import math

import pytest
import torch

from bench import harness as H


def _run(root, name, seed=4242):
    return H.run(name, seed, 0.3, False, 0.0, device="cpu", root=root)


def _patch(monkeypatch, module, name, make):
    monkeypatch.setattr(module, name, make(getattr(module, name)))


# ---------------------------------------------------------------- sweep ----

def test_sweep_step_that_returns_its_state_unchanged(tiny_root, monkeypatch):
    from repro_torch.core import evolve as E
    _patch(monkeypatch, E, "make_batched_generation_step",
           lambda make: lambda *a, **k: (lambda state, *x: state))
    line = _run(tiny_root, "tiny.sweep")
    assert not line["correct"] and line["checks"]["key_mismatch"]["value"]


def test_sweep_half_of_the_runs_left_out(tiny_root, monkeypatch):
    from repro_torch.core import evolve as E

    def make(orig):
        def build(*a, **k):
            step = orig(*a, **k)

            def half(state, *x):
                new = step(state, *x)
                n = new.parent_fit.shape[0] // 2
                return type(new)(*(
                    type(o)(*(torch.cat([f[:n], g[n:]]) for f, g in zip(o, s)))
                    if isinstance(o, tuple) else torch.cat([o[:n], s[n:]])
                    for o, s in zip(new, state)))
            return half
        return build
    _patch(monkeypatch, E, "make_batched_generation_step", make)
    assert not _run(tiny_root, "tiny.sweep")["correct"]


def test_sweep_answer_altered_where_it_is_produced(tiny_root, monkeypatch):
    from repro_torch.core import evolve as E
    _patch(monkeypatch, E, "eval_segment",
           lambda f: lambda *a, **k: (f(*a, **k)[0] * 1.001,
                                      f(*a, **k)[1]))
    line = _run(tiny_root, "tiny.sweep")
    assert not line["correct"] and \
        line["checks"]["metric_gap"]["value"] > 1e-4


def _kept_on_a_tie(f):
    """Selection without neutral drift: the parent stays where the best
    offspring only ties it."""
    def inner(state, offspring, fits, *a):
        low = torch.nextafter(state.parent_fit, torch.tensor(-math.inf))
        new = f(state._replace(parent_fit=low), offspring, fits, *a)
        return new._replace(parent_fit=torch.where(
            new.parent_fit == low, state.parent_fit, new.parent_fit))
    return inner


def _last_of_the_tied(f):
    """The last offspring of least fitness taken, not the first."""
    def inner(state, offspring, fits, mets, powers):
        flip = lambda t: t.flip(1)
        return f(state, type(offspring)(*map(flip, offspring)), flip(fits),
                 flip(mets), flip(powers))
    return inner


@pytest.mark.parametrize("fault", [_kept_on_a_tie, _last_of_the_tied])
def test_sweep_selection_that_breaks_the_rule(tiny_root, monkeypatch,
                                              fault):
    from repro_torch.core import evolve as E
    _patch(monkeypatch, E, "_select", fault)
    line = _run(tiny_root, "tiny.sweep")
    assert not line["correct"] and \
        line["checks"]["selection_mismatch"]["value"] > 0


# ------------------------------------------------------------ eval, decode --

@pytest.mark.parametrize("name", ["tiny.eval", "tiny.decode"])
def test_lm_last_layer_left_out(tiny_root, monkeypatch, name):
    from torch import nn

    from bench.drivers import lm as L

    def drop(f):
        def inner(*a, **k):
            params = f(*a, **k)
            params.layers = nn.ModuleList(list(params.layers)[:-1])
            return params
        return inner
    _patch(monkeypatch, L, "program_model", drop)
    line = _run(tiny_root, name)
    assert not line["correct"] and line["checks"]["wiring"]["value"] > 0


@pytest.mark.parametrize("name", ["tiny.eval", "tiny.decode"])
def test_lm_key_projection_fed_the_un_normed_activation(tiny_root,
                                                        monkeypatch, name):
    """wk reads the attention block's input, not its norm's output."""
    from repro_torch.models import attention as A
    seen, calls = {}, []

    def stash(f):
        def inner(params, x, *a, **k):
            seen["x"] = x
            return f(params, x, *a, **k)
        return inner

    def fault(f):
        def inner(x, w, *a, **k):
            calls.append(None)       # q, k, v, o in each layer
            return f(seen["x"] if len(calls) % 4 == 2 else x, w, *a, **k)
        return inner
    for fn in ("self_attention", "decode_self_attention"):
        _patch(monkeypatch, A, fn, stash)
    _patch(monkeypatch, A, "matmul", fault)
    line = _run(tiny_root, name)
    assert not line["correct"] and line["checks"]["wiring"]["value"] > 0


# ----------------------------------------------------------------- eval ----

def test_eval_loss_altered_where_it_is_produced(tiny_root, monkeypatch):
    from repro_torch.models import model as M
    _patch(monkeypatch, M, "lm_loss", lambda f: lambda *a: f(*a) + 0.05)
    assert not _run(tiny_root, "tiny.eval")["correct"]


# --------------------------------------------------------------- decode ----

def test_decode_step_that_leaves_the_cache_unchanged(tiny_root,
                                                     monkeypatch):
    from repro_torch.models import model as M
    _patch(monkeypatch, M, "decode_step",
           lambda f: lambda p, cache, *a: (
               f(p, [{k: v.clone() for k, v in c.items()} for c in cache],
                 *a)[0], cache))
    line = _run(tiny_root, "tiny.decode")
    assert not line["correct"] and line["checks"]["kv_gap"]["value"] > 0.5


def test_decode_half_of_the_sessions_left_out(tiny_root, monkeypatch):
    from repro_torch.models import model as M

    def half(f):
        def step(p, cache, tok, pos, cfg):
            logits, cache = f(p, cache, tok, pos, cfg)
            logits[logits.shape[0] // 2:] = 0
            return logits, cache
        return step
    _patch(monkeypatch, M, "decode_step", half)
    assert not _run(tiny_root, "tiny.decode")["correct"]


def test_decode_token_altered_where_it_is_produced(tiny_root, monkeypatch):
    from repro_torch.models import model as M

    def alter(f):
        def step(*a):
            logits, cache = f(*a)
            top = logits[0, 0].argmax()
            logits[0, 0, (top + 1) % logits.shape[-1]] += 100
            return logits, cache
        return step
    _patch(monkeypatch, M, "decode_step", alter)
    line = _run(tiny_root, "tiny.decode")
    assert not line["correct"] and line["checks"]["token_gap"]["value"] > 0


# -------------------------------------------------------------- control ----

@pytest.mark.parametrize("name", ["tiny.sweep", "tiny.eval", "tiny.decode"])
def test_the_control_fails_the_check(tiny_root, name):
    cell = H.find_cell(name, tiny_root)
    out, _ = H.driver(cell).run(cell, 99, 0.3, False, "cpu", control=True)
    assert all(c.ok for c in out.checks)
    limits = cell.params["limits"]
    assert not all(H.Check(k, out.control.get(k, math.inf), limits[k]).ok
                   for k in limits), out.control
