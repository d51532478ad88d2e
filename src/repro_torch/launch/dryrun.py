"""Dry run of the production cells on a fake ``torch.distributed`` world
(``repro/launch/dryrun.py``'s analogue): does every (architecture × shape
× mesh) cell shard coherently, and what does a rank hold and do?

The reference lowers and compiles each cell for 512 forced host devices
and reads XLA's memory and cost analyses and the HLO.  Here one process
joins a world of 256 (``single``) or 512 (``multi``) ranks on the
``fake`` backend, as rank 0, builds ``launch.mesh.make_production_mesh``
(its groups are made collectively, which the fake backend makes cheap)
and runs rank 0's step -- the SAME step functions the launchers run
(``launch/steps.py``): train_4k -> train step (gradients + optimizer),
prefill_32k -> prefill, decode_32k / long_500k -> decode step, with
``seq_shard`` when the batch is smaller than dp -- under ``FakeTensorMode``
on ``--device``: shapes, dtypes and devices propagate, nothing is
allocated or computed.  Rank 0 holds exactly its at-rest slices
(``parallel.ctx.Sharding.index``) and, as every entry point of the port,
the whole batch.  The step running to its end proves the sharding is
coherent.

One dispatch mode (``Counter``) counts what the step does:

* FLOPs by dtype, through ``torch.utils.flop_counter``'s formulas (the
  ones ``FlopCounterMode`` uses);
* the bytes each aten op reads and writes (its tensor inputs and outputs
  once; views and allocations move none).  The port runs eager, so this
  is its unfused traffic.  A copy between the host and the card is counted
  apart, as ``transfer bytes`` (the step number's scalar, put on the card
  each optimizer step, is one): so ``--device cpu`` and ``cuda`` count the
  same FLOPs, bytes and collectives;
* every ``c10d`` collective, by output bytes, under the reference's op
  names (all-gather, all-reduce, reduce-scatter, all-to-all; broadcast
  too), by the span of its group (``roofline.link``: inside one 8-rank
  node or across nodes) and by its group's size (``per_group``: a mesh
  line's, or a head group's ``ctx.Mesh.subgroup``).  The reference's
  ``parse_collective_bytes`` has no counterpart: there is no HLO;
  every collective the port issues, the CGP side's included, reaches
  the dispatcher as a ``c10d`` op;
* the hand-written kernels' calls, which take ``kernels/ops.py``'s abstract
  route on fake tensors (their work is priced by ``roofline``'s work
  models, not counted as aten ops).

``torch.distributed._tools.mem_tracker.MemTracker`` gives the step's peak.
Records keep the reference's keys where the meaning carries over (``ok``,
``n_devices``, ``memory_analysis`` with ``argument_size_in_bytes``,
``output_size_in_bytes``, ``temp_size_in_bytes`` and
``alias_size_in_bytes``, ``cost_analysis`` with ``flops`` and ``bytes
accessed``, ``collectives`` with ``total_bytes`` and ``per_op``,
``n_periods``); ``trace_s`` stands where the reference has ``lower_s``
and ``compile_s``.  ``temp_size_in_bytes`` is the peak above the
arguments (outputs included, unlike XLA's); ``alias_size_in_bytes`` the
outputs that are arguments updated in place.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_2_1b \
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cgp --mesh multi

``--device`` is the device of the fake tensors: ``cuda`` by default, which
needs a card, as every entry point of the port; ``cpu`` gives the same
counts.  Records go to ``--out`` (default ``experiments/dryrun_h100``).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from collections import defaultdict

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch import convert as C
from repro_torch.configs import base as B
from repro_torch.core import metrics as MM
from repro_torch.core.evolve import (EvolveConfig, evolve_sharded,
                                     make_island_keys)
from repro_torch.core.search import SearchConfig, problem_arrays
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import link
from repro_torch.models import model as M
from repro_torch.models import quant
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.parallel import ctx

aten = torch.ops.aten
# c10d op -> the reference's collective name
COLLECTIVES = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast",
}
# allocations and view-like ops: no bytes moved
FREE = {aten.empty.memory_format, aten.empty_strided.default,
        aten.empty_like.default, aten.new_empty.default,
        aten.new_empty_strided.default, aten._unsafe_view.default}
# copies between devices: the host side of the traffic crosses PCIe, not
# the card's memory ("transfer bytes": what lands on the other device)
COPIES = {aten._to_copy.default, aten.copy_.default}
DEFAULT_OUT = "experiments/dryrun_h100"


def _bytes(t: torch.Tensor) -> int:
    """The bytes a tensor's elements occupy (a broadcast dim, stride 0,
    counts once)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _group_ranks(args) -> list:
    """The global ranks of the process group among a c10d op's
    arguments."""
    for a in args:
        if isinstance(a, torch.ScriptObject) and \
                "ProcessGroup" in str(a._type()):
            return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
    raise ValueError("collective without a process group")


class Counter(TorchDispatchMode):
    """Counts the FLOPs by dtype, the bytes of every aten op and the
    collectives of what runs under it (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops: dict[str, int] = defaultdict(int)
        self.bytes = 0
        self.transfer = 0
        self.per_op: dict[str, int] = defaultdict(int)
        self.calls: dict[str, int] = defaultdict(int)
        self.per_link: dict[str, int] = defaultdict(int)
        self.per_group: dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            out = func(*args, **kwargs)
            if func._opname in COLLECTIVES:
                name = COLLECTIVES[func._opname]
                n = sum(_bytes(t) for t in _tensors(args[0]))
                self.per_op[name] += n
                self.calls[name] += 1
                ranks = _group_ranks(args)
                self.per_link[link(ranks)] += n
                self.per_group[str(len(ranks))] += n
            return out
        if func.namespace == "prim":
            return func(*args, **kwargs)
        # as FlopCounterMode: an op with a composite form counts its parts
        with self:
            out = func.decompose(*args, **kwargs)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            first = _tensors((args, kwargs))[0]
            self.flops[str(first.dtype).removeprefix("torch.")] += \
                flop_registry[packet](*args, **kwargs, out_val=out)
        read, written = _tensors((args, kwargs)), _tensors(out)
        if func in COPIES and {t.device for t in read + written} != {
                t.device for t in written}:
            self.transfer += sum(_bytes(t) for t in written)
        elif written and not func.is_view and func not in FREE:
            self.bytes += sum(_bytes(t) for t in read + written)
        return out

    def record(self) -> dict:
        return {
            "cost_analysis": {"flops": float(sum(self.flops.values())),
                              "bytes accessed": float(self.bytes),
                              "transfer bytes": float(self.transfer),
                              "flops_by_dtype": dict(self.flops)},
            "collectives": {"total_bytes": float(sum(self.per_op.values())),
                            "per_op": dict(self.per_op),
                            "calls": dict(self.calls),
                            "per_link": dict(self.per_link),
                            "per_group": dict(self.per_group)}}


def kernel_calls(traced: list) -> list:
    """``ops.TRACED`` as one entry per (kernel, shape, dtype) with its
    number of calls, in first-call order."""
    out: dict = {}
    for c in traced:
        key = (c["kernel"], tuple(c["shape"]), c["dtype"])
        out.setdefault(key, dict(c, calls=0))["calls"] += 1
    return list(out.values())


def _storages(tree) -> dict:
    """Each distinct storage of the tensors (and modules' parameters) in
    ``tree`` -> its bytes."""
    leaves = []
    for x in tree_leaves(tree):
        if isinstance(x, torch.nn.Module):
            leaves.extend(x.parameters())
        elif isinstance(x, torch.Tensor):
            leaves.append(x)
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in leaves}


def trace(fn, args) -> dict:
    """Run ``fn(*args)`` under the counters: its FLOPs, bytes and
    collectives (``Counter``), its hand-written kernel calls
    (``ops.TRACED``) and its memory (``MemTracker``: the peak with the
    arguments resident).  Under ``FakeTensorMode`` nothing runs; on real
    tensors (``tests/``) the same counts come from a real run."""
    counter = Counter()
    arg_storages = _storages(args)
    tracker = MemTracker()
    tracker.track_external(*[x for x in tree_leaves(args)
                             if isinstance(x, (torch.Tensor,
                                               torch.nn.Module))])
    ops.TRACED.clear()
    t0 = time.perf_counter()
    with tracker, counter:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    calls, ops.TRACED[:] = kernel_calls(ops.TRACED), []
    peak = sum(snap["Total"] for snap in
               tracker.get_tracker_snapshot("peak").values())
    out_storages = _storages(out)
    arg_bytes = sum(arg_storages.values())
    rec = counter.record()
    rec.update({
        "trace_s": round(seconds, 2),
        "memory_analysis": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": sum(out_storages.values()),
            "temp_size_in_bytes": max(0, peak - arg_bytes),
            "alias_size_in_bytes": sum(n for s, n in out_storages.items()
                                       if s in arg_storages),
            "peak_bytes": peak},
        "kernels": calls})
    return rec


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """This process as rank 0 of an ``n_ranks`` world on the ``fake``
    backend (no communication: collectives return their outputs'
    shapes)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_cell(arch_id: str, shape: B.ShapeConfig, device,
               cfg: B.ModelConfig | None = None):
    """(step_fn, args, cfg) for one cell on the active mesh: this rank's
    at-rest slices of the parameters, optimizer state and cache, the whole
    batch (zeros), made on ``device`` under whatever mode is active
    (``FakeTensorMode`` in the dry run).  ``cfg`` overrides the
    architecture's ``CONFIG``."""
    mod = B.get_arch(arch_id)
    cfg = cfg or mod.CONFIG
    batch = {k: torch.zeros(s, dtype=dt, device=device)
             for k, (s, dt) in B.input_specs(cfg, shape).items()}
    params = C.shard_params(M.skeleton(cfg, device), cfg)
    if shape.mode == "train":
        opt_cfg = OptConfig(name=getattr(mod, "OPTIMIZER", "adamw"))
        state = init_opt_state(C.reference_tree(params, cfg), opt_cfg)
        return (ST.make_train_step(cfg, opt_cfg),
                (params, state, batch, 0), cfg)
    if shape.mode == "prefill":
        return ST.make_prefill_step(cfg), (params, batch), cfg
    seq_shard = shape.global_batch < ctx.axis_size("dp")
    cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                         device=device)
    return (ST.make_decode_step(cfg, seq_shard=seq_shard),
            (params, cache, batch), cfg)


def trace_cell(arch_id: str, shape: B.ShapeConfig, mesh, device,
               cfg: B.ModelConfig | None = None) -> dict:
    """``trace`` of one cell's step on ``mesh`` (rank 0 of a fake world),
    on fake tensors of ``device``."""
    cfg = cfg or B.get_arch(arch_id).CONFIG
    if cfg.approx_matmul:
        # the table is made real, so no fake one is cached for later calls
        quant.get_multiplier_lut(device)
    with ctx.use_mesh(mesh), FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, cfg = build_cell(arch_id, shape, device, cfg)
        rec = trace(fn, args)
    rec["n_periods"] = cfg.n_periods
    return rec


def _mesh_name(multi_pod: bool) -> str:
    return "multi" if multi_pod else "single"


def _write(rec: dict, out_dir: str | None, tag: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, device="cuda") -> dict:
    device = resolve_device(device)
    shape = {s.name: s for s in B.ALL_SHAPES}[shape_name]
    n = 512 if multi_pod else 256
    rec = {"arch": arch_id, "shape": shape_name,
           "mesh": _mesh_name(multi_pod), "n_devices": n,
           "device": str(device)}
    try:
        with fake_world(n):
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            rec.update(trace_cell(arch_id, shape, mesh, device))
        rec["ok"] = True
    except Exception as e:  # a cell that does not shard is a result
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    _write(rec, out_dir, f"{arch_id}__{shape_name}__{rec['mesh']}")
    return rec


CGP_WIDTH, CGP_NODES = 8, 400
CGP_CONFIG = dict(generations=64, lam=8)    # the reference's cell


def build_cgp_cell(mesh, pod_axis: str | None = None, **overrides):
    """(fn, args, EvolveConfig) of the paper's workload on ``mesh``: the
    8-bit array multiplier, 400 nodes, ``EvolveConfig(generations=64,
    lam=8)`` (``overrides`` replace fields) through
    ``core.evolve.evolve_sharded``, one island per data coordinate (per
    pod), each island's cube over ``model``.  The inputs are made on the
    CPU (the step moves them to the mesh's device)."""
    gold, spec, planes, gvals, _ = problem_arrays(
        SearchConfig(width=CGP_WIDTH, kind="mul", n_n=CGP_NODES), "cpu")
    n_pods = mesh.shape.get("pod", 1)
    cfg = EvolveConfig(**{**CGP_CONFIG, **overrides})
    thr = torch.zeros((n_pods, MM.N_METRICS), dtype=torch.float32)
    fn = evolve_sharded(mesh, spec, cfg, gold, thr, torch.tensor(100.0),
                        pod_axis=pod_axis)
    keys = make_island_keys(0, mesh.shape["data"] * n_pods)
    return fn, (thr, keys, planes, gvals), cfg


def combine(records: list, weights: list) -> dict:
    """Σ weight · record over the counts of ``trace`` records (FLOPs,
    bytes, collectives, memory, kernel calls; integer weights; clamped at
    0): the counts of a run made of the traced ones' parts."""
    def num(recs, ws):
        if isinstance(recs[0], dict):
            keys = dict.fromkeys(k for r in recs for k in r)
            return {k: num([r.get(k, 0) for r in recs], ws) for k in keys}
        return max(0, sum(w * r for w, r in zip(ws, recs)))

    def calls(rec):
        return {json.dumps([c["kernel"], c["shape"], c["dtype"]]):
                c["calls"] for c in rec["kernels"]}

    out = num([{k: r[k] for k in ("cost_analysis", "collectives",
                                  "memory_analysis")} for r in records],
              weights)
    n = num([calls(r) for r in records], weights)
    out["kernels"] = [dict(zip(("kernel", "shape", "dtype"), json.loads(k)),
                           calls=int(v)) for k, v in n.items() if v]
    out["trace_s"] = round(sum(r["trace_s"] for r in records), 2)
    return out


def trace_cgp(mesh, device, pod_axis: str | None = None,
              **overrides) -> dict:
    """``trace`` of the CGP cell on ``mesh`` (rank 0 of a fake world), on
    fake tensors of ``device``, from three short traces: G generations are
    G identical steps, and an island migration after every
    ``migrate_every``-th, so with A = 1 generation, A2 = 2 and Am = 1
    generation followed by a migration, the counts are A + (G - 1)(A2 - A)
    + ⌊G / migrate_every⌋(Am - A) exactly.  The peak is an estimate:
    the largest traced one plus G - 2 generations' rows of the histories
    (on a (2, 2) world 0.2% above a 64-generation trace's)."""
    cfg = EvolveConfig(**{**CGP_CONFIG, **overrides})
    recs = []
    for gens, every in ((1, 3), (2, 3), (1, 1)):
        fn, args, _ = build_cgp_cell(mesh, pod_axis, **{
            **overrides, "generations": gens, "migrate_every": every})
        with ctx.use_mesh(mesh), FakeTensorMode(allow_non_fake_inputs=True):
            recs.append(trace(fn, args))
    G, m = cfg.generations, cfg.migrate_every
    rec = combine(recs, [1 - (G - 1) - G // m, G - 1, G // m])
    mem = [r["memory_analysis"] for r in recs]
    peak = max(x["peak_bytes"] for x in mem) + (G - 2) * (
        mem[1]["output_size_in_bytes"] - mem[0]["output_size_in_bytes"])
    rec["memory_analysis"].update(
        argument_size_in_bytes=mem[0]["argument_size_in_bytes"],
        peak_bytes=peak,
        temp_size_in_bytes=peak - mem[0]["argument_size_in_bytes"])
    rec.update({"n_generations": G, "migrate_every": m})
    return rec


def run_cgp_cell(multi_pod: bool, out_dir: str | None = None,
                 device="cuda") -> dict:
    """Dry-run the paper's own workload: the distributed CGP evolve."""
    device = resolve_device(device)
    n = 512 if multi_pod else 256
    rec = {"arch": "cgp_mult8", "shape": "evolve_64g",
           "mesh": _mesh_name(multi_pod), "n_devices": n,
           "device": str(device)}
    try:
        with fake_world(n):
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            rec.update(trace_cgp(mesh, device,
                                 "pod" if multi_pod else None))
        rec["ok"] = True
    except Exception as e:
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    _write(rec, out_dir, f"cgp_mult8__evolve__{rec['mesh']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cgp", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda needs a card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.cgp:
        for mp in meshes:
            rec = run_cgp_cell(mp, args.out, device)
            print(json.dumps({k: rec.get(k) for k in
                              ("arch", "shape", "mesh", "ok", "error")}),
                  flush=True)
        return
    cells = []
    if args.all:
        for arch in B.ARCH_IDS:
            for shape in B.shapes_for(arch):
                cells.append((arch, shape.name))
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all, or --cgp")
        cells.append((args.arch, args.shape))
    for arch, shape in cells:
        for mp in meshes:
            rec = run_cell(arch, shape, mp, args.out, device)
            brief = {k: rec.get(k) for k in
                     ("arch", "shape", "mesh", "ok", "trace_s", "error")}
            print(json.dumps(brief), flush=True)


if __name__ == "__main__":
    main()
