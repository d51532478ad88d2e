"""Readings that a cell's limits are set from: for each seed, the numbers
the check compares for the program and for the control (the reference
put in the program's place at the precision below the configuration's).

  python3 bench/control.py --workload phi4_mini.eval4k --seconds 5 \\
      --seeds 11 12 13

Each seed runs the cell as the benchmark does (a short window), then the
check, then the control on the same inputs; one JSON line per seed, with
each side's verdict through the harness's own comparison (``Check``): the
program's has to be true, the control's false.
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    import argparse
    import json
    import math

    from bench import harness as H
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cell = H.find_cell(a.workload)
    limits = cell.params["limits"]
    for seed in a.seeds:
        t0 = time.perf_counter()
        out, _ = H.driver(cell).run(cell, seed, a.seconds, False, a.device,
                                    control=True)
        low = [H.Check(k, out.control.get(k, math.inf), limits[k])
               for k in limits]
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "program": {c.name: c.value for c in out.checks},
                          "program_correct": all(c.ok for c in out.checks),
                          "control": out.control,
                          "control_correct": all(c.ok for c in low),
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
