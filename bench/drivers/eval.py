"""Driver of quality evaluation: the program's ``lm_loss`` in inference
mode over batches of seeded tokens (uniform over the whole vocabulary),
back to back, each loss read back to the host as a user's evaluation
loop reads it.  ``eval_tokens_per_s`` is the tokens scored over the
window.

The check runs the next batch after the window through the same call,
capturing it operation by operation, and has ``reference.lm_check`` judge
each operation from the program's own inputs and the loss from its last
hidden state (the reference makes the weights and the table anew from the
seed and the genome).

A traced run profiles ``trace_batches`` batches, recording each
``lut_matmul`` and ``flash_attention`` call's work-model bound.
"""
from __future__ import annotations

import time

import torch

from bench import harness as H
from bench import seeds
from bench.drivers import lm as L
from bench.workmodels import flash_attention as WF
from bench.workmodels import lm_step as WS
from bench.workmodels import lut_matmul as WL


def run(cell: H.Cell, seed: int, seconds: float, traced: bool,
        device: str = "cuda", control: bool = False):
    from repro_torch.kernels import ops
    from repro_torch.models import model as M

    dev = torch.device(device)
    t = cell.traffic
    prog = L.Program(cell, seed, dev)
    s, cfg, params = prog.s, prog.cfg, prog.params
    B, S = t["batch"], t["seq_len"]

    def batch(i):
        toks = L.seeded_tokens(seed, dev, s["vocab_size"], (B, S + 1),
                               "eval", i)
        return toks[:, :-1], toks[:, 1:]

    def forward(i):
        tok, tgt = batch(i)
        return M.lm_loss(params, tok, tgt, cfg).item()

    losses, metrics, trace = [], {}, None
    with torch.inference_mode():
        for i in range(t["warmup_batches"]):
            forward(-1 - i)
        setup_end = H.set_up_done(dev)
        if not traced:
            win = H.Window(seconds)
            while win.more():
                losses.append(forward(len(losses)))
            elapsed = win.close()
            metrics["eval_tokens_per_s"] = B * S * len(losses) / elapsed
        else:
            from bench.trace import profiler
            calls: dict = {}
            wraps = L.recorder(ops, calls, WL.bound_ms, WF.bound_ms)
            wraps[(M, "lm_loss")] = H.labelled("lm_loss")
            with H.Patched(wraps), profiler(dev) as prof:
                t0 = time.perf_counter()
                for _ in range(t["trace_batches"]):
                    losses.append(forward(len(losses)))
                window_s = time.perf_counter() - t0
            trace = L.device_trace(prof, window_s, calls,
                                   WS.forward_flops(s, B, S) * len(losses),
                                   dev)
    peak = H.peak(dev)

    # the check: the next batch, captured operation by operation
    cap = L.Capture()
    tok, tgt = batch(len(losses))
    with torch.inference_mode(), H.Patched(cap.wraps()):
        loss = M.lm_loss(params, tok, tgt, cfg).item()
    del params
    checks, low = prog.check({"tokens": tok, "events": cap.events,
                              "pos": torch.arange(S, device=dev)},
                             B * S, control, loss=loss, targets=tgt)
    out = H.Outcome(attempted=len(losses),
                    failed=int(not all(c.ok for c in checks)),
                    metrics=metrics, checks=checks,
                    device=seeds.device_info(dev, peak), trace=trace,
                    control=low)
    return out, setup_end
