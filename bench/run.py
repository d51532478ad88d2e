"""Run one cell of the port's benchmark (``BENCHMARK.json``) on this
machine's card and print its result as the last line of standard output.

  python3 bench/run.py --workload mul8.c4096 --seed 7 --seconds 40 --trace 0

Run it from the root of a checkout: the program is ``src/repro_torch``.
Every build and kernel cache the run makes stays under ``.bench_cache/``
and the kernels' own ``src/repro_torch/kernels/build/``.
"""
import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
