"""CGP approximation launcher on the PyTorch/CUDA port — the paper's
experiment as a CLI.

  PYTHONPATH=src python -m repro_torch.launch.evolve --width 8 \
      --constraint "mae=0.5,er=60" --generations 2000 --seeds 3

Runs on the card; ``--device cpu`` runs the plain PyTorch path instead.
Prints the same ``[evolve] … runs/s`` line and JSON rows as
``repro.launch.evolve``.  ``--results-dir`` streams one result shard per
chunk, and ``--export-artifacts DIR`` then exports the elites as a LUT
registry that ``repro_torch.launch.serve --approx-lut DIR`` serves:

  PYTHONPATH=src python -m repro_torch.launch.evolve --width 8 \
      --constraint "mae=0.5,er=60" --generations 2000 --seeds 16 \
      --results-dir R --history summary --export-artifacts REG
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.metrics import METRIC_NAMES
from repro_torch.core.search import SearchConfig, run_sweep_serial
from repro_torch.core.sweep import SweepConfig, run_sweep_batched


def parse_constraint(s: str) -> ConstraintSpec:
    kw = {}
    for part in s.split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        k = k.strip()
        if k in ("acc0", "gauss"):
            kw[k] = v.strip().lower() in ("1", "true", "yes", "")
        else:
            kw[k] = float(v)
    return ConstraintSpec(**kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--kind", default="mul", choices=["mul", "add"])
    ap.add_argument("--nodes", type=int, default=400)
    ap.add_argument("--constraint", action="append", required=True,
                    help='e.g. "mae=0.5,er=60" (repeatable)')
    ap.add_argument("--generations", type=int, default=2000)
    ap.add_argument("--lam", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--chunk-size", type=int, default=32,
                    help="runs evaluated together (one kernel launch per "
                         "generation for chunk x lambda genomes)")
    ap.add_argument("--history", default="full",
                    choices=["full", "summary", "none"],
                    help="per-generation parent histories: in RAM and in "
                         "the shards ('full'), in the --results-dir shards "
                         "only ('summary'), or nowhere ('none')")
    ap.add_argument("--results-dir", default=None,
                    help="stream each finished chunk to an on-disk result "
                         "shard (core.results; readable by either package)")
    ap.add_argument("--export-artifacts", default=None, metavar="DIR",
                    help="after the sweep, export per-constraint elite "
                         "circuits from --results-dir as fingerprinted LUT "
                         "artifacts + registry.json into DIR, the input of "
                         "`serve --approx-lut`")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "genome_major", "cube_major"],
                    help="cgp_sim kernel variant: genome_major reads the "
                         "input cube from device memory per genome, "
                         "cube_major stages each run of the cube in shared "
                         "memory and walks a group of genomes over it; auto "
                         "resolves the measured tuning table "
                         "(kernels/tune.py).  The runs are the same either "
                         "way")
    ap.add_argument("--serial", action="store_true",
                    help="reference serial loop instead of the batched engine")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: the hand-written kernel) or 'cpu' "
                         "(the plain PyTorch path)")
    args = ap.parse_args(argv)
    if args.export_artifacts and (args.serial or not args.results_dir):
        ap.error("--export-artifacts reads the sweep back from its result "
                 "shards: it needs --results-dir and the batched engine")
    if args.export_artifacts and args.kind != "mul":
        ap.error("--export-artifacts builds multiplier LUT artifacts; "
                 "--kind add is not exportable")

    cfg = SearchConfig(width=args.width, kind=args.kind, n_n=args.nodes,
                       evolve=EvolveConfig(generations=args.generations,
                                           lam=args.lam, layout=args.layout))
    constraints = [parse_constraint(c) for c in args.constraint]
    if args.serial:
        records = run_sweep_serial(cfg, constraints, seeds=range(args.seeds),
                                   device=args.device)
    else:
        result = run_sweep_batched(
            cfg, constraints, seeds=range(args.seeds),
            sweep=SweepConfig(chunk_size=args.chunk_size,
                              keep_history=args.history,
                              results_dir=args.results_dir,
                              layout=args.layout),
            device=args.device)
        records = result.records
        print(f"[evolve] {result.completed}/{result.n_runs} runs "
              f"@ {result.runs_per_sec:.2f} runs/s", flush=True)
        if args.results_dir:
            reader = result.reader()
            print(f"[evolve] {len(reader.spans())} result shards "
                  f"({reader.completed}/{reader.n_runs} runs, history mode "
                  f"{reader.keep_history!r}) -> {args.results_dir}",
                  flush=True)
    for r in records:
        met = {n: round(float(v), 4) for n, v in zip(METRIC_NAMES, r.metrics)}
        row = {"constraint": r.constraint, "seed": r.seed,
               "power_rel": round(r.power_rel, 4),
               "feasible": r.feasible, "metrics": met}
        print(json.dumps(row), flush=True)
    if args.export_artifacts:
        from repro_torch.core.artifacts import export_elites
        registry = export_elites(args.results_dir, args.export_artifacts)
        print(f"[evolve] exported {len(registry['artifacts'])} LUT "
              f"artifact(s) -> {args.export_artifacts} "
              f"(grid {registry['grid_fingerprint'][:12]}...)", flush=True)


if __name__ == "__main__":
    main()
