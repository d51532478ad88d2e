"""Quickstart on the PyTorch/CUDA port: evolve an approximate 4x4
multiplier under COMBINED error constraints (paper Eq. 9) and print its
full characterization.

    python examples/quickstart_torch.py [--generations 4000] [--device cpu]

The port's counterpart of ``examples/quickstart.py``: start from the exact
array multiplier, mutate under fitness ``power if (MAE<=1% ∧ ER<=60%) else
∞``, and report the trade-off.  Runs on the card by default (and raises
without one); ``--device cpu`` runs the plain PyTorch path.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np

from repro_torch.core import metrics as M
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.search import SearchConfig, run_search


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--generations", "--gens", type=int, default=4000)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu' (the plain path)")
    args = ap.parse_args(argv)
    cfg = SearchConfig(
        width=4,                      # 4x4 multiplier: 2^8 exhaustive inputs
        n_n=150,
        evolve=EvolveConfig(generations=args.generations, lam=8),
    )
    constraint = ConstraintSpec(mae=1.0, er=60.0)   # the combined objective
    print(f"Evolving under: {constraint.describe()}")
    rec, res = run_search(cfg, constraint, seed=0, device=args.device)

    print(f"\nfeasible:        {rec.feasible}")
    print(f"relative power:  {rec.power_rel:.3f}  "
          f"(power reduction {100 * (1 - rec.power_rel):.1f}%)")
    for name, idx in (("MAE%", M.MAE), ("WCE%", M.WCE), ("ER%", M.ER),
                      ("MRE%", M.MRE), ("|AVG|%", M.AVG)):
        print(f"{name:8s} {rec.metrics[idx]:.4f}")
    print(f"ACC0 holds:      {bool(rec.metrics[M.ACC0])}")
    print(f"error mean/std:  {rec.error_mean:.2f} / {rec.error_std:.2f}")

    hist = res.hist_power_rel.cpu().numpy()
    step = max(1, args.generations // 8)
    print(f"\npower trajectory (every {step} gens): "
          f"{[round(float(h), 3) for h in hist[::step]]}")
    print(f"first feasible improvement at generation "
          f"{int(np.argmax(hist < 1.0)) if (hist < 1.0).any() else 'n/a'}")


if __name__ == "__main__":
    main()
