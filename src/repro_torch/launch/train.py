"""Training launcher on the PyTorch port: LM training on one device or a
mesh of ranks (every architecture: dense, MoE with its aux loss, SSM,
hybrid, and the vision and audio front ends' stubs).

Wires together the deterministic data pipeline, the optimizer, step
checkpoints written in the background with auto-resume, the heartbeat /
straggler guard and the train step of ``launch/steps.py``.  Prints the same
lines as ``repro.launch.train``; its checkpoints are the reference's (the
parameters in the reference's tree, the optimizer state leaf for leaf), so
either package resumes the other's run.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

Runs on the card; ``--device cpu`` runs the plain PyTorch path.  Weights
are random, drawn whole from a seeded ``torch.Generator`` with the
reference's distributions (on a mesh, every rank draws them and keeps its
slice).

``--mesh`` is the reference's: ``none`` (one device), ``host`` (every rank
on the "model" axis, ``1 × N``), ``single`` (16 × 16 ranks) and ``multi``
(2 × 16 × 16), which raise on a world of another size.  Under
``torchrun`` the CLI joins the world from the environment; alone it is a
one-rank world:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch llama3_2_1b --reduced --mesh host --device cpu

The backend is ``gloo`` with ``--device cpu``; on cuda it is ``nccl``
when every rank of the host has its own card, else ``gloo`` (ranks that
share a card), and rank 0 prints which.  Parameters and optimizer state
are laid out by ``param_specs`` / ``opt_state_specs``; a checkpoint is
written whole by rank 0 and resumes onto any mesh.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import socket
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch import convert as C
from repro_torch.checkpoint import store
from repro_torch.configs import base as B
from repro_torch.data.pipeline import DataConfig, synth_batch
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as meshes
from repro_torch.launch import steps as ST
from repro_torch.models import model as M
from repro_torch.optim import OptConfig, init_opt_state, opt_state_specs
from repro_torch.parallel import collectives as coll
from repro_torch.parallel import ctx
from repro_torch.runtime.fault import (HeartbeatMonitor, StragglerDetector,
                                       TrainGuard)

MESHES = ("none", "host", "single", "multi")


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@contextlib.contextmanager
def joined_world(dev: torch.device):
    """An initialized process group for the block: the caller's, the
    ``torchrun`` launcher's (``init_method="env://"``), or a one-rank
    world; the last two are destroyed after.  Yields (this rank's device,
    the backend for the mesh's groups: None to keep the caller's).

    Such a world's default group is gloo; on cuda the mesh's groups are
    nccl when every rank of a host has its own card, else gloo (ranks that
    share a card), decided once, from the ranks' host names, before any
    group is made."""
    if dist.is_initialized():
        yield dev, None
        return
    with tempfile.TemporaryDirectory(prefix="train_world_") as tmp:
        if dist.is_torchelastic_launched():
            dist.init_process_group("gloo", init_method="env://")
        else:
            dist.init_process_group(
                "gloo", init_method="file://" + os.path.join(tmp, "store"),
                rank=0, world_size=1)
        try:
            backend, rank = "gloo", dist.get_rank()
            if dev.type == "cuda":
                hosts = [None] * dist.get_world_size()
                dist.all_gather_object(hosts, socket.gethostname())
                mine = [r for r, h in enumerate(hosts) if h == hosts[rank]]
                count = torch.cuda.device_count()
                dev = torch.device("cuda", mine.index(rank) % count)
                torch.cuda.set_device(dev)
                if len(mine) <= count:
                    backend = "nccl"
            if rank == 0:
                print(f"[train] {dist.get_world_size()} rank(s), backend "
                      f"{backend}", flush=True)
            yield dev, backend
        finally:
            dist.destroy_process_group()


def build_mesh(name: str, device, backend: str | None = None
               ) -> ctx.Mesh | None:
    """The reference's ``--mesh`` over this world's ranks (its groups on
    ``backend``, default: the world's)."""
    kw = {"device": device, "backend": backend}
    if name == "single":
        return meshes.make_production_mesh(multi_pod=False, **kw)
    if name == "multi":
        return meshes.make_production_mesh(multi_pod=True, **kw)
    if name == "host":
        return meshes.make_host_mesh(**kw)
    if name == "none":
        return None
    raise ValueError(name)


def train(arch: str, steps: int = 50, batch: int | None = None,
          seq: int | None = None, reduced: bool = True,
          mesh_name: str = "none", ckpt_dir: str | None = None,
          ckpt_every: int = 20, microbatches: int = 1,
          opt_name: str | None = None, seed: int = 0,
          log_every: int = 10, device: torch.device | str | None = None,
          params: M.Transformer | None = None,
          config: B.ModelConfig | None = None,
          mesh: ctx.Mesh | None = None) -> dict:
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    newest step if it has one).

    ``params`` defaults to random weights drawn from ``seed`` (given ones
    are trained in place, cut to this rank's slices on a mesh); ``config``
    replaces the architecture's configuration; ``mesh`` (built on the
    caller's initialized world) replaces ``mesh_name``'s.  Returns the
    losses of the steps run, the final loss,
    ``wall_s``, per-step host times (``data_s``: the batch made and
    copied to the device, ``step_s``: the train step to its loss on the
    host, ``coll_s``: its collectives while ``parallel.collectives.timed``
    is on, else 0, ``ckpt_submit_s``: the host copy of each checkpoint,
    ``ckpt_write_s``: each background write), and the trained ``params``
    and ``opt_state``."""
    if mesh_name not in MESHES:
        raise ValueError(mesh_name)
    dev = resolve_device(device)
    if mesh is not None:
        with ctx.use_mesh(mesh):
            return _train(arch, steps, batch, seq, reduced, mesh, ckpt_dir,
                          ckpt_every, microbatches, opt_name, seed,
                          log_every, dev, params, config)
    if mesh_name == "none":
        return _train(arch, steps, batch, seq, reduced, None, ckpt_dir,
                      ckpt_every, microbatches, opt_name, seed, log_every,
                      dev, params, config)
    with joined_world(dev) as (dev, backend):
        mesh = build_mesh(mesh_name, dev, backend)
        with ctx.use_mesh(mesh):
            return _train(arch, steps, batch, seq, reduced, mesh, ckpt_dir,
                          ckpt_every, microbatches, opt_name, seed,
                          log_every, dev, params, config)


def _train(arch, steps, batch, seq, reduced, mesh, ckpt_dir, ckpt_every,
           microbatches, opt_name, seed, log_every, dev, params, config):
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
    shardings = None
    if mesh is not None:
        if not any(hasattr(p, "sharding") for p in params.parameters()):
            C.shard_params(params, cfg)
        pspecs = M.param_specs(cfg)
        shardings = {"params": ST.resolve_tree(pspecs),
                     "opt": ST.resolve_tree(opt_state_specs(pspecs,
                                                            opt_cfg))}
    opt_state = init_opt_state(C.reference_tree(params, cfg), opt_cfg)
    writer = _rank() == 0

    def save(step, loss, background=True):
        tree = {"params": C.reference_tree(params, cfg), "opt": opt_state}
        meta = {"arch": arch, "loss": loss}
        if shardings is not None:
            tree = store.gather_to_host(tree, shardings, writer)
        if not writer:
            return
        if background:
            ckpt.save(ckpt_dir, step, tree, metadata=meta)
        else:
            store.save_checkpoint(ckpt_dir, step, tree, metadata=meta)

    start_step = 0
    ckpt = store.AsyncCheckpointer()
    if ckpt_dir:
        latest = store.latest_step(ckpt_dir)
        if latest is not None:
            tmpl = {"params": C.reference_tree(params, cfg),
                    "opt": opt_state}
            tree, _ = store.load_checkpoint(ckpt_dir, latest, tmpl,
                                            shardings)
            C.load_reference_tree(params, tree["params"], cfg)
            opt_state = tree["opt"]
            start_step = latest
            if writer:
                print(f"[train] resumed from step {latest}", flush=True)

    img = None
    if cfg.frontend == "vision":        # the stub's image embeddings
        img = torch.zeros((batch, cfg.n_img_tokens, cfg.d_model),
                          dtype=cfg.adtype(), device=dev)
    guard = TrainGuard(HeartbeatMonitor(deadline_s=300.0),
                       StragglerDetector())
    host = f"host{_rank()}"
    losses, data_s, step_s, submit_s, coll_s = [], [], [], [], []
    saved = None
    t_start = time.time()
    for s in range(start_step, steps):
        t0 = time.time()
        tb = {k: torch.as_tensor(v, dtype=torch.int64, device=dev)
              for k, v in synth_batch(dcfg, s).items()}
        if img is not None:
            tb["image_embeds"] = img
        t1 = time.time()
        c0 = coll.STATS["seconds"]
        params, opt_state, metrics = step_fn(params, opt_state, tb, s)
        loss = float(metrics["loss"])
        t2 = time.time()
        coll_s.append(coll.STATS["seconds"] - c0)
        losses.append(loss)
        data_s.append(t1 - t0)
        step_s.append(t2 - t1)
        status = guard.step(host, time.time() - t0)
        if status["stragglers"]:
            print(f"[guard] stragglers: {status['stragglers']}", flush=True)
        if ckpt_dir and (s + 1) % ckpt_every == 0:
            save(s + 1, loss)
            saved = s + 1
            submit_s.append(time.time() - t2)
        if writer and (s % log_every == 0 or s == steps - 1):
            print(f"[train] step {s} loss {loss:.4f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
    ckpt.wait()
    if ckpt_dir and losses and saved != steps:
        # the reference's final save; skipped when the background save of
        # the last step already wrote the same step
        save(steps, losses[-1], background=False)
    if ckpt_dir and writer:
        store.cleanup(ckpt_dir, keep=3)
    if mesh is not None:
        dist.barrier()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "steps": steps, "start_step": start_step,
            "wall_s": time.time() - t_start, "data_s": data_s,
            "step_s": step_s, "coll_s": coll_s, "ckpt_submit_s": submit_s,
            "ckpt_write_s": ckpt.write_seconds, "params": params,
            "is_writer": writer,
            "opt_state": opt_state, "config": cfg, "opt_config": opt_cfg}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="none", choices=list(MESHES),
                    help="none: one device; host: every rank on the model "
                         "axis; single / multi: the 16x16 / 2x16x16 "
                         "production meshes")
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
    if out["is_writer"]:
        print(f"[train] done: final loss {out['final_loss']:.4f} "
              f"in {out['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
