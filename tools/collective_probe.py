"""Which collectives a ``torch.distributed`` backend takes on CUDA tensors,
and what they cost, for ranks that share one card.

Spawns ``--ranks`` processes (``repro_torch.parallel.spawn.run_ranks``)
on the card, each in a ``--backend`` group (default gloo: NCCL refuses two
ranks on one device), and prints one JSON line: for each call
(``all_gather`` and ``reduce_scatter`` in their list forms,
``all_to_all_single`` of uint8 (a prefill's cache to its layout at rest),
``all_reduce`` of float32 / bfloat16 / int32 / uint8, MAX / MIN), whether
it ran, and whether an int32 SUM (``collectives.sum_int32``, the LUT
path's tensor-parallel sums) gives the host's sums, wrapping past 2^31 as
int32 addition does; then the median ms of
``parallel.collectives``' all-gather, reduce-scatter and float32
all-reduce at a few sizes, with the size over the time.

  python3 tools/collective_probe.py [--ranks 2] [--backend gloo]

Needs a card; run from the repository root.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SIZES_MB = (1, 16, 128, 512)


def _probe_rank(rank, world, reps):
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as meshes
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel import ctx
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out = {"calls": {}, "timing": {}}
    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    calls = {
        "all_gather": lambda: dist.all_gather(
            [torch.empty(8, device=dev) for _ in range(world)], x),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty(8 // world, device=dev), list(x.chunk(world))),
        "all_reduce float32": lambda: dist.all_reduce(x.clone()),
        "all_reduce bfloat16": lambda: dist.all_reduce(
            x.to(torch.bfloat16)),
        "all_reduce int32": lambda: dist.all_reduce(x.to(torch.int32)),
        "all_reduce uint8": lambda: dist.all_reduce(x.to(torch.uint8)),
        "all_to_all_single uint8": lambda: dist.all_to_all_single(
            torch.empty(8 * world, dtype=torch.uint8, device=dev),
            x.to(torch.uint8).repeat(world)),
        "all_reduce max": lambda: dist.all_reduce(
            x.clone(), op=dist.ReduceOp.MAX),
        "all_reduce min": lambda: dist.all_reduce(
            x.clone(), op=dist.ReduceOp.MIN),
    }
    for name, call in calls.items():
        try:
            call()
            torch.cuda.synchronize()
            out["calls"][name] = "ok"
        except Exception as e:  # noqa: BLE001 — the probe reports it
            out["calls"][name] = f"{type(e).__name__}: {str(e)[:120]}"
        dist.barrier()
    mesh = meshes.make_debug_mesh(n_data=world, n_model=1, device=dev)
    # int32 SUM by value: every rank's block, some near 2^31 so the sum
    # wraps; the host sums the same blocks in int64 and wraps them
    blocks = [torch.randint(-2**31, 2**31 - 1, (1000,), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(r))
              for r in range(world)]
    want = (sum(b.long() for b in blocks) + 2**31) % 2**32 - 2**31
    with ctx.use_mesh(mesh):
        got = coll.sum_int32([blocks[rank].to(dev)], ("data",))[0]
    out["calls"]["sum_int32 by value"] = (
        "ok" if torch.equal(got.cpu().long(), want) else "wrong")
    for mb in SIZES_MB:
        n = mb * 2 ** 20 // 4 // world
        local = torch.full((n,), float(rank), device=dev)
        want = torch.arange(world, device=dev).repeat_interleave(n).float()
        whole = torch.full((n * world,), float(rank), device=dev)
        for name, fn in (
                ("all_gather", lambda: coll.all_gather_raw(
                    local, mesh, ("data",), 0)),
                ("reduce_scatter", lambda: coll.reduce_scatter_raw(
                    whole, mesh, ("data",), 0)),
                ("all_reduce", lambda: coll.all_reduce_raw(
                    local, mesh, ("data",)))):
            got = fn()
            if name == "all_gather" and not torch.equal(got, want):
                raise AssertionError(f"{name} disagrees")
            times = []
            for _ in range(reps):
                dist.barrier()
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            ms = sorted(times)[len(times) // 2]
            out["timing"][f"{name} {mb} MB"] = {
                "ms": round(ms, 3),
                "GB_per_s": round(mb * 2 ** 20 / 1e9 / (ms / 1e3), 3)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("collective_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.parallel.spawn import run_ranks
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    res = run_ranks(_probe_rank, args.ranks, args.reps,
                    backend=args.backend, timeout_s=600.0)
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "backend": args.backend, "ranks": args.ranks,
                      "calls": res[0]["calls"],
                      "timing_rank0": res[0]["timing"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
