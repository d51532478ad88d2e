"""Training launcher on the PyTorch port: LM training on one device (every
architecture: dense, MoE with its aux loss, SSM, hybrid, and the vision
and audio front ends' stubs).

Wires together the deterministic data pipeline, the optimizer, step
checkpoints written in the background with auto-resume, the heartbeat /
straggler guard and the train step of ``launch/steps.py``.  Prints the same
lines as ``repro.launch.train``; its checkpoints are the reference's (the
parameters in the reference's tree, the optimizer state leaf for leaf), so
either package resumes the other's run.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Runs on the card; ``--device cpu`` runs the plain PyTorch path.  Weights
are random, drawn from a seeded ``torch.Generator`` with the reference's
distributions.  Only ``--mesh none`` (one device) is ported.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import convert as C
from repro_torch.checkpoint import store
from repro_torch.configs import base as B
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.device import resolve_device
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.runtime.fault import (HeartbeatMonitor, StragglerDetector,
                                       TrainGuard)

MESHES = ("none", "host", "single", "multi")


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def train(arch: str, steps: int = 50, batch: int | None = None,
          seq: int | None = None, reduced: bool = True,
          mesh_name: str = "none", ckpt_dir: str | None = None,
          ckpt_every: int = 20, microbatches: int = 1,
          opt_name: str | None = None, seed: int = 0,
          log_every: int = 10, device: torch.device | str | None = None,
          params: M.Transformer | None = None,
          config: B.ModelConfig | None = None) -> dict:
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    newest step if it has one).

    ``params`` defaults to random weights drawn from ``seed`` (given ones
    are trained in place); ``config`` replaces the architecture's
    configuration.  Returns the losses of the steps run, the final loss,
    ``wall_s``, per-step host times (``data_s``: the batch made and
    copied to the device, ``step_s``: the train step to its loss on the
    host, ``ckpt_submit_s``: the host copy of each checkpoint,
    ``ckpt_write_s``: each background write), and the trained ``params``
    and ``opt_state``."""
    if mesh_name not in MESHES:
        raise ValueError(mesh_name)
    if mesh_name != "none":
        raise NotImplementedError(
            f"--mesh {mesh_name}: the multi-device LM is not ported yet "
            f"(ROADMAP Queue A item 7); use --mesh none")
    dev = resolve_device(device)
    mod = B.get_arch(arch)
    cfg = config or (mod.reduced() if reduced else mod.CONFIG)
    opt_cfg = OptConfig(name=opt_name or getattr(mod, "OPTIMIZER", "adamw"),
                        total_steps=max(steps, 2))
    step_fn = ST.make_train_step(cfg, opt_cfg, microbatches=microbatches)
    batch = batch or (8 if reduced else B.TRAIN_4K.global_batch)
    seq = seq or (64 if reduced else B.TRAIN_4K.seq_len)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                      seed=seed, n_codebooks=cfg.n_codebooks)

    if params is None:
        params = M.init_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)
    params = params.to(dev)
    opt_state = init_opt_state(C.reference_tree(params, cfg), opt_cfg)

    start_step = 0
    ckpt = store.AsyncCheckpointer()
    if ckpt_dir:
        latest = store.latest_step(ckpt_dir)
        if latest is not None:
            tmpl = {"params": C.reference_tree(params, cfg),
                    "opt": opt_state}
            tree, _ = store.load_checkpoint(ckpt_dir, latest, tmpl)
            C.load_reference_tree(params, tree["params"], cfg)
            opt_state = tree["opt"]
            start_step = latest
            print(f"[train] resumed from step {latest}", flush=True)

    img = None
    if cfg.frontend == "vision":        # the stub's image embeddings
        img = torch.zeros((batch, cfg.n_img_tokens, cfg.d_model),
                          dtype=cfg.adtype(), device=dev)
    guard = TrainGuard(HeartbeatMonitor(deadline_s=300.0),
                       StragglerDetector())
    host = f"host{_rank()}"
    losses, data_s, step_s, submit_s = [], [], [], []
    saved = None
    t_start = time.time()
    for s in range(start_step, steps):
        t0 = time.time()
        tb = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
              for k, v in synth_batch(dcfg, s).items()}
        if img is not None:
            tb["image_embeds"] = img
        t1 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, tb, s)
        loss = float(metrics["loss"])
        t2 = time.time()
        losses.append(loss)
        data_s.append(t1 - t0)
        step_s.append(t2 - t1)
        status = guard.step(host, time.time() - t0)
        if status["stragglers"]:
            print(f"[guard] stragglers: {status['stragglers']}", flush=True)
        if ckpt_dir and (s + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, s + 1,
                      {"params": C.reference_tree(params, cfg),
                       "opt": opt_state},
                      metadata={"arch": arch, "loss": loss})
            saved = s + 1
            submit_s.append(time.time() - t2)
        if s % log_every == 0 or s == steps - 1:
            print(f"[train] step {s} loss {loss:.4f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
    ckpt.wait()
    if ckpt_dir and losses and saved != steps:
        # the reference's final save; skipped when the background save of
        # the last step already wrote the same step
        store.save_checkpoint(ckpt_dir, steps,
                              {"params": C.reference_tree(params, cfg),
                               "opt": opt_state},
                              metadata={"arch": arch, "loss": losses[-1]})
    if ckpt_dir:
        store.cleanup(ckpt_dir, keep=3)
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "steps": steps, "start_step": start_step,
            "wall_s": time.time() - t_start, "data_s": data_s,
            "step_s": step_s, "ckpt_submit_s": submit_s,
            "ckpt_write_s": ckpt.write_seconds, "params": params,
            "opt_state": opt_state, "config": cfg, "opt_config": opt_cfg}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="none", choices=list(MESHES),
                    help="only 'none' (one device) is ported")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain PyTorch "
                         "path)")
    args = ap.parse_args(argv)
    out = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                reduced=args.reduced, mesh_name=args.mesh,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                microbatches=args.microbatches, opt_name=args.optimizer,
                seed=args.seed, device=args.device)
    print(f"[train] done: final loss {out['final_loss']:.4f} "
          f"in {out['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
