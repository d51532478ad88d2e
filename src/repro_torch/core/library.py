"""The product table of an evolved multiplier: the deployment artifact.

On silicon the evolved circuit is the multiplier inside a MAC array; here
serving emulates it exactly through its ``(2^w, 2^w)`` product table,
which ``models/quant.py`` and ``kernels/lut_matmul.py`` consume.  The
reference's JSON circuit library (``save_library`` / ``select_best``) is
not ported; the fingerprinted registry of ``core.artifacts`` takes its
place on the deployment path.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.genome import CGPSpec, Genome
from repro_torch.core.simulate import simulate_values


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
