"""The benchmark's harness: finds a cell from ``BENCHMARK.json`` and its
files, runs its driver, reads its per-layer metrics, and prints the
result.

A cell is found by name, and everything it is made of is a file of its
own, found by the names in ``BENCHMARK.json``:

  * the configuration: the ``file`` of its ``configs`` entry;
  * the traffic mix: ``bench/traffic/<traffic>.json``, whose ``kind``
    names the driver ``bench/drivers/<kind>.py`` that runs it;
  * the cell's own parameters and limits: ``bench/cells/<cell>.json``;
  * each per-layer metric: a reader ``bench/metrics/<metric>.py`` with a
    function ``read(trace)`` that returns the value or None.

So a cell, a configuration or a metric is added by adding files and
entries.  A driver's ``run(cell, seed, seconds, trace)`` returns a
``Outcome``; the harness turns it into the one result line.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    params: dict
    end_to_end: list
    per_layer: list
    root: Path = ROOT


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its files
    read; raises KeyError for a name the benchmark does not have."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; the benchmark has "
                       f"{sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    reports = [m for m in spec["end_to_end"]
               if name in m.get("workloads", cells)]
    names = {m["name"] for m in reports}
    layers = [m for m in spec["per_layer"]
              if (name in m["workloads"] if "workloads" in m
                  else m["moves"] in names)]
    return Cell(name=name, chips=w["chips"], config=_json(root / cfg["file"]),
                traffic=_json(root / "bench" / "traffic"
                              / f"{w['traffic']}.json"),
                params=_json(root / "bench" / "cells" / f"{name}.json"),
                end_to_end=reports, per_layer=layers, root=root)


def driver(cell: Cell):
    return importlib.import_module(f"bench.drivers.{cell.traffic['kind']}")


def reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    path = root / "bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Window:
    """The measured window: it closes at the first step boundary after
    ``seconds``; ``close`` takes its end once the device is done."""

    def __init__(self, seconds: float, clock=time.perf_counter):
        self.clock = clock
        self.seconds = seconds
        self.start = clock()
        self.end = None

    def more(self) -> bool:
        return self.clock() - self.start < self.seconds

    def close(self) -> float:
        self.end = self.clock()
        return self.end - self.start


@dataclasses.dataclass
class Check:
    """One number compared with its limit: holds when value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: dict            # end-to-end values by name (untraced run)
    checks: list             # [Check]
    device: dict             # platform, kind, count, memory_peak_bytes
    trace: object = None     # bench.trace.Trace of a traced run
    control: dict | None = None  # the control's numbers (bench/control.py)


class Patched:
    """Replaces functions of the program's modules by wrappers of them
    for a traced window (``{(module, name): make_wrapper}``), and puts
    them back."""

    def __init__(self, wraps: dict):
        self.wraps = wraps
        self.saved = {}

    def __enter__(self):
        for (mod, name), make in self.wraps.items():
            self.saved[(mod, name)] = getattr(mod, name)
            setattr(mod, name, make(getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)


def sync(dev) -> None:
    """Waits for the device (a no-op on the CPU)."""
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def set_up_done(dev) -> float:
    """Ends set-up: waits for the device, starts the window's memory peak
    afresh and returns the time."""
    import torch
    sync(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    return time.perf_counter()


def peak(dev) -> int:
    """The device memory allocated at most since set-up ended."""
    import torch
    dev = torch.device(dev)
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def labelled(name: str):
    """A wrapper maker that opens the host range ``bench:<name>`` of the
    profiler around each call."""
    def wrap(fn):
        def inner(*a, **k):
            from torch.profiler import record_function
            with record_function(f"bench:{name}"):
                return fn(*a, **k)
        return inner
    return wrap


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _finite(v: float) -> float:
    """A number JSON can carry: non-finite values as +-1e300."""
    v = float(v)
    if v != v or v == float("inf"):
        return 1e300
    return -1e300 if v == float("-inf") else v


def result(cell: Cell, out: Outcome, setup_s: float, traced: bool) -> dict:
    """The result line's object; ``checks`` comes last."""
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    line = {"correct": all(c.ok for c in out.checks),
            "attempted": out.attempted, "failed": out.failed}
    if traced:
        vals = {}
        for m in cell.per_layer:
            v = reader(m["name"], cell.root)(out.trace)
            if v is not None:
                vals[m["name"]] = v
        dev = dict(out.device, busy_s=out.trace.busy_s(),
                   window_s=out.trace.window_s)
    else:
        vals = dict(out.metrics, setup_s=setup_s)
        dev = out.device
    line["metrics"] = {k: {"value": v, "unit": units[k]}
                       for k, v in vals.items() if k in units}
    line["device"] = dev
    if traced:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = {c.name: {"value": _finite(c.value), "limit": c.limit}
                      for c in out.checks}
    return line


def run(name: str, seed: int, seconds: float, traced: bool, t0: float,
        device: str = "cuda", root: Path = ROOT) -> dict:
    """Run the cell and return its result object (no printing)."""
    cell = find_cell(name, root)
    drv = driver(cell)
    out, setup_end = drv.run(cell, seed, seconds, traced, device)
    return result(cell, out, setup_end - t0, traced)


def main(argv=None, t0: float | None = None) -> int:
    import argparse
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="Run one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = find_cell(a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {a.workload} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    line = run(a.workload, a.seed, a.seconds, bool(a.trace), t0)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}", file=sys.stderr)
        return 4
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0
