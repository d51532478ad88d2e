"""Serving launcher on the PyTorch port: batched prefill + decode with
continuous batching, optionally on an evolved approximate multiplier.

Requests are admitted into fixed decode slots, prefilled, decoded greedily
step by step; finished slot batches are refilled from the queue.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_2_1b \
      --requests 8 --prompt-len 32 --gen-len 16

``--approx-lut`` takes a registry artifact (or a registry directory: the
lowest-power feasible entry) that has passed digest and genome-replay
verification, and routes every projection matmul through the evolved
multiplier's product table (``models/quant.approx_matmul`` →
``kernels/ops.lut_matmul``, the hand-written CUDA kernel on the card).  It
then reports perplexities and logit errors against exact int8 and the
unquantized model; ``--summary-out`` writes the report as JSON.  Runs on the
card; ``--device cpu`` (with ``--reduced``) runs the plain PyTorch path.
Prints the same lines as ``repro.launch.serve``.  Weights are random, drawn
from a seeded ``torch.Generator`` with the reference's distributions.
Every architecture serves: attention layers keep a KV cache, SSM layers
an ``SSMState``, MoE layers decode at full capacity, cross-attention
layers attend to the vision stub's image embeddings (zeros unless the
caller gives its own); audio prompts are (prompt_len, n_codebooks) and a
decode step feeds every codebook's argmax back and records codebook 0's,
as the reference does.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import base as B
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models import quant


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) or (S, C) token ids
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    done: bool = False


def _config(arch: str, reduced: bool) -> B.ModelConfig:
    mod = B.get_arch(arch)
    return mod.reduced() if reduced else mod.CONFIG


def _random_params(cfg: B.ModelConfig, seed: int, device) -> M.Transformer:
    return M.init_params(torch.Generator(device=device).manual_seed(seed),
                         cfg)


def serve(arch: str, n_requests: int = 8, prompt_len: int = 32,
          gen_len: int = 16, slots: int = 4, reduced: bool = True,
          seed: int = 0, approx_lut: np.ndarray | None = None,
          device: torch.device | str | None = None,
          params: M.Transformer | None = None,
          image_embeds: torch.Tensor | None = None) -> dict:
    """Run the continuous-batching loop; returns throughput and outputs.

    ``approx_lut`` (a 256×256 integer product table) routes every
    projection matmul through the emulated approximate multiplier for the
    whole run; the previously installed table is restored on exit.
    ``params`` defaults to random weights drawn from ``seed``;
    ``image_embeds`` (vision: (slots, n_img_tokens, d_model), attended by
    every slot batch) to the reference's stub, zeros.
    """
    dev = resolve_device(device)
    cfg = _config(arch, reduced)
    prev_lut = quant._LUT
    if approx_lut is not None:
        if tuple(np.shape(approx_lut)) != (256, 256):
            raise ValueError(
                f"approx_lut must be a 256x256 product table (8-bit "
                f"operands), got {np.shape(approx_lut)} — re-export from a "
                f"width-8 sweep")
        cfg = dataclasses.replace(cfg, approx_matmul=True)
        quant.set_multiplier_lut(approx_lut)
    try:
        if params is None:
            params = _random_params(cfg, seed, dev)
        return _serve_loop(cfg, params, n_requests, prompt_len, gen_len,
                           slots, seed, dev, image_embeds)
    finally:
        quant.set_multiplier_lut(prev_lut)


@torch.inference_mode()
def _serve_loop(cfg: B.ModelConfig, params: M.Transformer, n_requests: int,
                prompt_len: int, gen_len: int, slots: int, seed: int,
                device, image_embeds: torch.Tensor | None = None) -> dict:
    rng = np.random.default_rng(seed)
    max_len = prompt_len + gen_len
    tok_shape = ((prompt_len, cfg.n_codebooks) if cfg.frontend == "audio"
                 else (prompt_len,))
    reqs = [Request(i, rng.integers(0, cfg.vocab, tok_shape,
                                    dtype=np.int32), gen_len)
            for i in range(n_requests)]
    pending = list(reqs)
    t0 = time.time()
    decoded_tokens = 0
    img = _image_embeds(cfg, slots, device, image_embeds)

    while pending or any(not r.done for r in reqs):
        batch_reqs = pending[:slots]
        pending = pending[len(batch_reqs):]
        if not batch_reqs:
            break
        while len(batch_reqs) < slots:          # pad the slot batch
            batch_reqs.append(batch_reqs[-1])
        prompts = torch.as_tensor(np.stack([r.prompt for r in batch_reqs]),
                                  dtype=torch.int64, device=device)
        logits, cache = M.prefill(params, prompts, cfg, max_len=max_len,
                                  image_embeds=img)
        pos = torch.full((slots,), prompt_len, dtype=torch.int64,
                         device=device)
        # (slots,), or (slots, C) for audio: every codebook is fed back
        next_tok = torch.argmax(logits[:, -1], dim=-1)
        for _ in range(gen_len):
            logits, cache = M.decode_step(params, cache, next_tok[:, None],
                                          pos, cfg)
            next_tok = torch.argmax(logits[:, -1], dim=-1)
            next_np = next_tok.cpu().numpy().reshape(slots, -1)
            for i, r in enumerate(batch_reqs):
                if not r.done and len(r.out) < r.max_new:
                    r.out.append(int(next_np[i, 0]))   # codebook 0
                    decoded_tokens += 1
                if len(r.out) >= r.max_new:
                    r.done = True
            pos = pos + 1
    wall = time.time() - t0
    return {"requests": n_requests, "decoded_tokens": decoded_tokens,
            "wall_s": wall, "tok_per_s": decoded_tokens / max(wall, 1e-9),
            "req_per_s": n_requests / max(wall, 1e-9),
            "outputs": {r.rid: r.out for r in reqs}}


def _image_embeds(cfg: B.ModelConfig, batch: int, device,
                  given: torch.Tensor | None) -> torch.Tensor | None:
    """The vision front end's embeddings: ``given``, or the reference's
    stub, zeros (batch, n_img_tokens, d_model) in the activation dtype;
    None without a vision front end."""
    if cfg.frontend != "vision":
        return None
    if given is not None:
        return given.to(device=device, dtype=cfg.adtype())
    return torch.zeros((batch, cfg.n_img_tokens, cfg.d_model),
                       dtype=cfg.adtype(), device=device)


@torch.inference_mode()
def quality_report(arch: str, lut: np.ndarray, *, reduced: bool = True,
                   batch: int = 4, seq_len: int = 32, seed: int = 0,
                   device: torch.device | str | None = None,
                   params: M.Transformer | None = None,
                   tokens: torch.Tensor | None = None,
                   image_embeds: torch.Tensor | None = None) -> dict:
    """Model-level damage of serving on the evolved multiplier.

    Evaluates the same parameters and token batch under three arithmetics —
    unquantized, exact int8 (quantization alone) and the approximate LUT —
    and reports perplexities, their deltas, and the mean |Δlogit| of the
    prefill logits against each baseline.  ``params`` and ``tokens``
    ((batch, seq_len), audio (batch, seq_len, C)) default to draws from
    ``seed``, ``image_embeds`` (vision) to the stub's zeros.
    """
    dev = resolve_device(device)
    cfg = _config(arch, reduced)
    cfg_q = dataclasses.replace(cfg, approx_matmul=True)
    if params is None:
        params = _random_params(cfg, seed, dev)
    if tokens is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        shape = ((batch, seq_len, cfg.n_codebooks)
                 if cfg.frontend == "audio" else (batch, seq_len))
        tokens = torch.randint(0, cfg.vocab, shape, generator=gen,
                               device=dev)
    tokens = tokens.to(dev)
    img = _image_embeds(cfg, tokens.shape[0], dev, image_embeds)

    prev_lut = quant._LUT
    try:
        def run(c):
            loss = float(M.lm_loss(params, tokens, tokens, c,
                                   image_embeds=img))
            logits, _ = M.prefill(params, tokens, c, image_embeds=img)
            return loss, logits.to(torch.float32).cpu().numpy()

        loss_fp, logits_fp = run(cfg)
        quant.set_multiplier_lut(None)          # exact-int8 baseline
        loss_i8, logits_i8 = run(cfg_q)
        quant.set_multiplier_lut(lut)           # evolved approximate circuit
        loss_ap, logits_ap = run(cfg_q)
    finally:
        quant.set_multiplier_lut(prev_lut)

    ppl_fp, ppl_i8, ppl_ap = (float(np.exp(v))
                              for v in (loss_fp, loss_i8, loss_ap))
    return {
        "ppl_fp32": ppl_fp, "ppl_int8": ppl_i8, "ppl_approx": ppl_ap,
        "ppl_delta_vs_fp32": ppl_ap - ppl_fp,
        "ppl_delta_vs_int8": ppl_ap - ppl_i8,
        "logit_mae_vs_fp32": float(np.abs(logits_ap - logits_fp).mean()),
        "logit_mae_vs_int8": float(np.abs(logits_ap - logits_i8).mean()),
        "eval_batch": int(tokens.shape[0]),
        "eval_seq_len": int(tokens.shape[1]),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's small smoke configuration")
    ap.add_argument("--approx-lut", default=None, metavar="ARTIFACT",
                    help="serve on an evolved approximate multiplier: a "
                         "registry artifact .npz, or a registry directory "
                         "(lowest-power feasible entry wins).  The artifact "
                         "is digest-verified and its LUT replayed from the "
                         "genome before anything is served; quality deltas "
                         "vs exact-int8 and fp32 are reported next to "
                         "throughput")
    ap.add_argument("--summary-out", default=None, metavar="PATH",
                    help="write the run's throughput + quality report as a "
                         "stamped deploy_summary.json (atomic write)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the hand-written kernels) or "
                         "'cpu' (the plain PyTorch path)")
    args = ap.parse_args(argv)

    art = None
    lut = None
    if args.approx_lut:
        from repro_torch.core.artifacts import resolve_artifact
        art = resolve_artifact(args.approx_lut)  # digest + genome verified
        lut = art.lut
        print(f"[serve] approx artifact {art.path}: {art.constraint} "
              f"(seed {art.seed}, power_rel={art.power_rel:.4f}, "
              f"certified={art.certified}, digest {art.digest[:12]}...)")

    out = serve(args.arch, n_requests=args.requests,
                prompt_len=args.prompt_len, gen_len=args.gen_len,
                slots=args.slots, reduced=args.reduced, approx_lut=lut,
                device=args.device)
    print(f"[serve] {out['requests']} requests, "
          f"{out['decoded_tokens']} tokens, {out['tok_per_s']:.1f} tok/s, "
          f"{out['req_per_s']:.2f} req/s")

    quality = None
    if lut is not None:
        quality = quality_report(args.arch, lut, reduced=args.reduced,
                                 seq_len=args.prompt_len, device=args.device)
        print(f"[serve] perplexity fp32 {quality['ppl_fp32']:.4f} | "
              f"exact-int8 {quality['ppl_int8']:.4f} | "
              f"approx {quality['ppl_approx']:.4f} "
              f"(delta vs int8 {quality['ppl_delta_vs_int8']:+.4f}, "
              f"vs fp32 {quality['ppl_delta_vs_fp32']:+.4f})")
        print(f"[serve] logit MAE vs int8 "
              f"{quality['logit_mae_vs_int8']:.4f}, vs fp32 "
              f"{quality['logit_mae_vs_fp32']:.4f}")

    if args.summary_out:
        from repro_torch.checkpoint.store import atomic_write_json
        summary = {
            "schema_version": 1,
            "generated_unix": time.time(),
            "arch": args.arch, "reduced": args.reduced,
            "device": args.device,
            "budget": {"requests": args.requests,
                       "prompt_len": args.prompt_len,
                       "gen_len": args.gen_len, "slots": args.slots},
            "artifact": None if art is None else {
                "path": art.path, "digest": art.digest,
                "grid_fingerprint": art.grid_fingerprint,
                "constraint": art.constraint, "seed": art.seed,
                "power_rel": art.power_rel, "feasible": art.feasible,
                "certified": art.certified,
                "metrics": art.metric_dict(),
            },
            "serve": {k: v for k, v in out.items() if k != "outputs"},
            "quality": quality,
        }
        atomic_write_json(args.summary_out, summary)
        print(f"[serve] wrote {args.summary_out}")


if __name__ == "__main__":
    main()
