"""Shared set-up of the benchmark's tests: the program and the benchmark
on the path, the ``card`` marker, and a throwaway benchmark root of tiny
cells made of files only."""
import json
import os
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

DATA = Path(__file__).resolve().parent / "data"
TINY = {
    "tiny.sweep": ("tiny_mul", "tiny_sweep",
                   {"check_runs": 8, "limits": {
                       "key_mismatch": 0, "foreign_parent": 0,
                       "selection_mismatch": 0,
                       "metric_gap": 1e-5, "power_gap": 1e-5,
                       "fitness_gap": 1e-5}}),
    "tiny.eval": ("tiny_lm", "tiny_eval", {"check_rows": 32, "limits": {
        "wiring": 0, "proj_gap": 0.005, "block_gap": 0.01,
        "loss_gap": 0.01}}),
    "tiny.decode": ("tiny_lm", "tiny_decode", {"check_rows": 32, "limits": {
        "wiring": 0, "proj_gap": 0.005, "block_gap": 0.01, "kv_gap": 0.01,
        "token_gap": 0}}),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present (decided here, when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def make_root(tmp: Path, extra: dict | None = None) -> Path:
    """A benchmark root holding the repository's BENCHMARK.json plus the
    tiny cells (and ``extra``), each cell added as files only."""
    root = tmp / "root"
    (root / "bench").mkdir(parents=True)
    for d in ("configs", "traffic", "cells"):
        shutil.copytree(REPO / "bench" / d, root / "bench" / d)
    os.symlink(REPO / "bench" / "metrics", root / "bench" / "metrics")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (config, traffic, params) in {**TINY, **(extra or {})}.items():
        src = {"tiny_mul": "tiny_circuit", "tiny_lm": "tiny_lm"}[config]
        shutil.copy(DATA / f"{src}.json",
                    root / "bench" / "configs" / f"{config}.json")
        shutil.copy(DATA / f"{traffic}.json",
                    root / "bench" / "traffic" / f"{traffic}.json")
        (root / "bench" / "cells" / f"{name}.json").write_text(
            json.dumps(params))
        if config not in {c["name"] for c in spec["configs"]}:
            spec["configs"].append({"name": config, "source": "tests",
                                    "file": f"bench/configs/{config}.json",
                                    "reduced": [], "why": "tests"})
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "tests"})
        kind = json.loads((DATA / f"{traffic}.json").read_text())["kind"]
        like = {"sweep": "mul8.c4096", "eval": "phi4_mini.eval4k",
                "decode": "phi4_mini.decode256"}[kind]
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
