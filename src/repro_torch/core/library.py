"""EvoApproxLib-style circuit library (paper Sec. I / Fig. 14).

Evolved circuits are stored as JSON records (genome + full
characterization), the same JSON as ``repro.core.library``'s, so an
application can select "the best circuit under constraint X" the way the
paper describes using EvoApproxLib (``save_library`` / ``load_library`` /
``select_best``).  ``multiplier_lut`` gives an evolved multiplier's product
table, the deployment artifact that ``models/quant.py`` and
``kernels/lut_matmul.py`` consume; the fingerprinted registry of
``core.artifacts`` carries it on the serving path.
"""
from __future__ import annotations

import json
import os
from typing import Iterable

import numpy as np
import torch

from repro_torch.core import metrics as M
from repro_torch.core.genome import CGPSpec, Genome
from repro_torch.core.search import CircuitRecord
from repro_torch.core.simulate import simulate_values
from repro_torch.device import resolve_device


def save_library(records: Iterable[CircuitRecord], path: str) -> None:
    data = []
    for r in records:
        data.append({
            "nodes": np.asarray(r.genome_nodes).tolist(),
            "outs": np.asarray(r.genome_outs).tolist(),
            "metrics": {n: float(v) for n, v in
                        zip(M.METRIC_NAMES, r.metrics)},
            "power_rel": r.power_rel,
            "constraint": r.constraint,
            "seed": r.seed,
            "feasible": r.feasible,
            "error_mean": r.error_mean,
            "error_std": r.error_std,
        })
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f)


def load_library(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)


def record_to_genome(rec: dict, device: torch.device | str | None = None
                     ) -> Genome:
    """A library record's genome on ``device`` (default: the card)."""
    dev = resolve_device(device)
    return Genome(torch.tensor(rec["nodes"], dtype=torch.int32, device=dev),
                  torch.tensor(rec["outs"], dtype=torch.int32, device=dev))


def select_best(records: list[dict], **max_metrics: float) -> dict | None:
    """Pick the lowest-power feasible circuit under the given metric caps.

    Example: ``select_best(lib, mae=0.1, er=50.0)``.
    """
    best, best_p = None, float("inf")
    for r in records:
        if not r["feasible"]:
            continue
        ok = all(r["metrics"][k] <= v if k not in ("acc0", "gauss")
                 else r["metrics"][k] >= 1.0
                 for k, v in max_metrics.items())
        if ok and r["power_rel"] < best_p:
            best, best_p = r, r["power_rel"]
    return best


def multiplier_lut(genome: Genome, spec: CGPSpec) -> np.ndarray:
    """(2^w, 2^w) int32 product table of a multiplier genome, ``[a, b]``.

    Input index ``x`` holds operand ``a`` in its low ``w`` bits and ``b``
    in its high bits, so the cube's values reshape to ``[b, a]`` and are
    transposed.  Cubes below 32 lanes (widths 1-2) come back tiled by
    whole-cube replication: the first ``2^n_i`` lanes are the cube.
    """
    w = spec.n_i // 2
    vals = simulate_values(genome, spec).cpu().numpy()[:1 << spec.n_i]
    return np.ascontiguousarray(vals.reshape(1 << w, 1 << w).T, np.int32)
