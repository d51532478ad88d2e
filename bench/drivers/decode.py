"""Driver of batched greedy decoding: ``sessions`` sessions, each with a
``context``-token KV cache made from the seed at the configuration's
shapes (the cache a prefill would have left, made in set-up instead of a
prefill through the table), decode together through the program's
``decode_step``; each step's next tokens are read back to the host, as
the serve loop reads them.  A session that reaches ``max_len`` ends and a
new one takes its slot at the end of the same context with a fresh token.

``tokens_per_s`` is the tokens served over the window; ``token_gap_ms_p90``
the 90th percentile over every gap between two consecutive tokens of one
session.

The check runs the next step after the window through the same call,
capturing it operation by operation, and has ``reference.lm_check`` judge
each operation from the program's own inputs and state (its cache, whose
earlier positions it wrote itself, and the key and value this step
wrote), and the served tokens by the reference's logits from the
program's last hidden state.

A traced run profiles ``trace_steps`` steps, recording each
``lut_matmul`` call's work-model bound and each ``decode_step`` call's
host time.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import harness as H
from bench import seeds
from bench.drivers import lm as L
from bench.workmodels import flash_attention as WF
from bench.workmodels import lm_step as WS
from bench.workmodels import lut_matmul as WL


def seeded_cache(s: dict, seed: int, dev, B: int, ctx: int, max_len: int):
    """(layers, 2, B, max_len, kv heads, head_dim) in the served dtype:
    N(0, 1) keys and values at positions before ``ctx``, zeros after."""
    buf = torch.empty((s["num_hidden_layers"], 2, B, max_len,
                       s["num_key_value_heads"], s["head_dim"]),
                      dtype=torch.bfloat16, device=dev)
    buf.normal_(0.0, 1.0, generator=seeds.torch_generator(seed, dev,
                                                          "cache"))
    buf[:, :, :, ctx:] = 0
    return buf


def run(cell: H.Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", control: bool = False):
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    dev = torch.device(device)
    t = cell.traffic
    prog = L.Program(cell, seed, dev)
    s, cfg, params = prog.s, prog.cfg, prog.params
    B, ctx, max_len = t["sessions"], t["context"], t["max_len"]
    V = s["vocab_size"]
    buf = seeded_cache(s, seed, dev, B, ctx, max_len)
    cache = [{"k": buf[i, 0], "v": buf[i, 1]} for i in range(len(buf))]
    rec = []            # (round, position, input tokens, served tokens)
    state = {"round": 0, "pos": ctx,
             "tok": L.seeded_tokens(seed, dev, V, (B,), "decode", 0)}
    state["host"] = state["tok"].cpu().numpy()

    def step():
        """One decode step; True where it began a new round."""
        new = state["pos"] == max_len
        if new:
            state["round"] += 1
            state["pos"] = ctx
            state["tok"] = L.seeded_tokens(seed, dev, V, (B,), "decode",
                                           state["round"])
            state["host"] = state["tok"].cpu().numpy()
        pos = torch.full((B,), state["pos"], dtype=torch.int64, device=dev)
        logits, _ = M.decode_step(params, cache, state["tok"][:, None], pos,
                                  cfg)
        nxt = logits[:, 0].argmax(-1)
        served = nxt.cpu().numpy()
        rec.append((state["round"], state["pos"], state["host"], served))
        state["tok"], state["host"] = nxt, served
        state["pos"] += 1
        return new

    metrics, trace, steps = {}, None, 0
    with torch.inference_mode():
        for _ in range(t["warmup_steps"]):
            step()
        setup_end = H.set_up_done(dev)
        if not traced:
            win = H.Window(seconds)
            gaps, last = [], win.start
            while win.more():
                new = step()
                now = time.perf_counter()
                if not new:
                    gaps.append(now - last)
                last = now
                steps += 1
            elapsed = win.close()
            metrics["tokens_per_s"] = B * steps / elapsed
            metrics["token_gap_ms_p90"] = float(
                np.percentile(np.repeat(gaps, B), 90)) * 1e3
        else:
            trace = _traced(t, s, B, ctx, step, rec, ops, M, dev)
            steps = t["trace_steps"]
    peak = H.peak(dev)

    # the check: the next step, captured operation by operation, against
    # the program's own cache
    cap = L.Capture()
    with torch.inference_mode(), H.Patched(cap.wraps()):
        step()
    _, pos, tok, served = rec[-1]
    del params
    capture = {"tokens": torch.as_tensor(tok, device=dev)[:, None],
               "pos": torch.tensor([pos], device=dev),
               "events": cap.events,
               "cache": [(c["k"][:, :pos + 1], c["v"][:, :pos + 1])
                         for c in cache]}
    checks, low = prog.check(capture, B, control,
                             served=torch.as_tensor(served, device=dev))
    out = H.Outcome(attempted=B * steps,
                    failed=0 if all(c.ok for c in checks) else B,
                    metrics=metrics, checks=checks,
                    device=seeds.device_info(dev, peak), trace=trace,
                    control=low)
    return out, setup_end


def _traced(t, s, B, ctx, step, rec, ops, M, dev):
    from bench.trace import profiler
    calls: dict = {}
    wraps = L.recorder(ops, calls, WL.bound_ms, WF.bound_ms)
    enqueue = []

    def timed(fn):
        def inner(*a, **k):
            t1 = time.perf_counter()
            r = fn(*a, **k)
            enqueue.append((time.perf_counter() - t1) * 1e3)
            return r
        return inner
    wraps[(M, "decode_step")] = lambda fn: H.labelled("decode_step")(
        timed(fn))
    n = t["trace_steps"]
    with H.Patched(wraps), profiler(dev) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        window_s = time.perf_counter() - t0
    flops = sum(WS.decode_flops(s, B, r[1] + 1) for r in rec[-n:])
    trace = L.device_trace(prof, window_s, calls, flops, dev)
    trace.spans["decode_step"] = enqueue
    trace.info["steps"] = n
    return trace
