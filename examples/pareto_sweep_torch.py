"""Paper-style constraint sweep -> Pareto fronts (Fig. 14 in miniature), on
the PyTorch/CUDA port.

    python examples/pareto_sweep_torch.py [--width 6] [--gens 800] \
        [--results-dir R] [--checkpoint-dir C] [--device cpu]

The port's counterpart of ``examples/pareto_sweep.py``: sweeps
single-metric objectives (MAE, ER) against the combined ER+MAE objective
and prints the power/metric Pareto fronts, the paper's headline claim
being that the combination wins.  ``--results-dir`` streams result shards
and reads the fronts back through ``SweepResultReader``;
``--checkpoint-dir`` checkpoints the sweep.  Rerun the same command to
resume an interrupted sweep.  Runs on the card by default (and raises
without one); ``--device cpu`` runs the plain PyTorch path.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core import metrics as M
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.search import SearchConfig
from repro_torch.core.sweep import SweepConfig, run_sweep_batched


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=4)
    ap.add_argument("--gens", "--generations", type=int, default=1500)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--chunk-size", type=int, default=32)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="resume an interrupted sweep from here")
    ap.add_argument("--results-dir", default=None,
                    help="stream per-chunk result shards here (resumable; "
                         "histories spill to disk, host memory stays flat) "
                         "and read the fronts back through SweepResultReader")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain path)")
    args = ap.parse_args(argv)

    cfg = SearchConfig(width=args.width, n_n=150 if args.width <= 4 else 300,
                       evolve=EvolveConfig(generations=args.gens, lam=8))
    strategies = {
        "mae-only": [ConstraintSpec(mae=t) for t in (0.2, 0.5, 1.0, 2.0)],
        "er-only": [ConstraintSpec(er=t) for t in (20, 40, 60, 80)],
        "er+mae": [ConstraintSpec(er=e, mae=m)
                   for e in (30, 60) for m in (0.5, 2.0)],
    }
    fronts = {}
    for name, cons in strategies.items():
        ckpt = (os.path.join(args.checkpoint_dir, name)
                if args.checkpoint_dir else None)
        rdir = (os.path.join(args.results_dir, name)
                if args.results_dir else None)
        res = run_sweep_batched(
            cfg, cons, seeds=range(args.seeds),
            sweep=SweepConfig(chunk_size=args.chunk_size,
                              checkpoint_dir=ckpt, results_dir=rdir,
                              keep_history="summary" if rdir else "none"),
            device=args.device)
        # with --results-dir the fronts come back through the on-disk shard
        # reader: the same fronts the in-RAM result gives
        src = res.reader() if rdir else res
        fronts[name] = src.fronts((M.MAE, M.ER))
        print(f"[{name}] {int(res.feasible.sum())} feasible circuits "
              f"@ {res.runs_per_sec:.2f} runs/s"
              + (f" -> {len(src.spans())} shards in {rdir}" if rdir else ""))

    for metric, idx in (("MAE%", M.MAE), ("ER%", M.ER)):
        print(f"\n=== power vs {metric} Pareto fronts ===")
        for name, front in fronts.items():
            pretty = ", ".join(f"({p:.2f}, {m:.2f})" for p, m in front[idx])
            print(f"{name:10s} {pretty}")


if __name__ == "__main__":
    main()
