"""Run a function on N local ranks of a fresh ``torch.distributed`` world.

The reference's distributed paths are one program over a device mesh; the
port's are one process per rank.  ``run_ranks`` starts ``world`` processes
with the ``spawn`` start method (never ``fork``: the parent may hold a CUDA
context), has each join a process group through a ``file://`` store in a
private directory (no port to pick), calls ``fn(rank, world, *args)`` and
returns each rank's result, in rank order.  A rank that raises, dies or is
still running at the deadline fails the whole call with ``RuntimeError``;
every process is gone when it returns or raises.

    from repro_torch.parallel.spawn import run_ranks
    results = run_ranks(fn, 2, backend="gloo")

``fn`` must be importable by the children (a module-level function), and
its result picklable.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback


def _rank_main(fn, rank: int, world: int, backend: str, init_file: str,
               out_file: str, timeout_s: float, args: tuple) -> None:
    import torch
    import torch.distributed as dist
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except Exception:  # reported to the parent, which raises
        out = ("error", traceback.format_exc())
    with open(out_file + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_file + ".tmp", out_file)
    if out[0] != "ok":
        raise SystemExit(1)


def run_ranks(fn, world: int, *args, backend: str = "gloo",
              timeout_s: float = 300.0, workdir: str | None = None) -> list:
    """``[fn(r, world, *args) for r in range(world)]``, each on its own
    rank of a ``backend`` process group.  Every rank must be done within
    ``timeout_s`` seconds of the start (a collective times out then too):
    the parent kills what is left at that deadline.  The store and the
    results pass through a new directory under ``workdir`` (default: the
    system's temporary directory), removed on return."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    tmp = tempfile.mkdtemp(prefix="ranks_", dir=workdir)
    ctx = mp.get_context("spawn")
    procs = []
    try:
        init_file = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        for r in range(world):
            p = ctx.Process(target=_rank_main, args=(
                fn, r, world, backend, init_file, outs[r], timeout_s, args),
                daemon=True)
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        errors = []
        for r, path in enumerate(outs):
            if r in hung:
                errors.append(f"rank {r}: still running at the deadline")
            elif not os.path.exists(path):
                errors.append(f"rank {r}: exited with code "
                              f"{procs[r].exitcode} and no result")
            else:
                with open(path, "rb") as f:
                    status, value = pickle.load(f)
                if status != "ok":
                    errors.append(f"rank {r}:\n{value}")
        if errors:
            raise RuntimeError(f"{len(errors)} of {world} ranks failed:\n"
                               + "\n".join(errors))
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f)[1])
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
