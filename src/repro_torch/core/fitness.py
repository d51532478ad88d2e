"""Combined-constraint fitness — paper Eq. (8) extended to Eq. (9).

    f(C) = cost(C)   if  ∧_i error_i(G, C) ≤ T_i
           ∞         otherwise

Thresholds are a dense (N_METRICS,) float32 vector aligned with
``metrics.METRIC_NAMES``; unconstrained entries are +inf.  The boolean metrics
(ACC0, GAUSS) are encoded as *required levels*: threshold 1.0 means "must
hold" (metric value must be ≥ 1), -inf means unconstrained — so the whole
predicate is a single vectorized comparison.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import metrics as M

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class ConstraintSpec:
    """Human-friendly constraint configuration (thresholds in paper units).

    mae/wce/avg are relative-% of the output range; er/mre are %;
    acc0/gauss are "must hold" booleans; gauss_sigma parameterizes Gauss_σ.
    """
    mae: float = INF
    wce: float = INF
    er: float = INF
    mre: float = INF
    avg: float = INF
    acc0: bool = False
    gauss: bool = False
    gauss_sigma: float = 256.0

    def thresholds(self) -> np.ndarray:
        t = np.full((M.N_METRICS,), INF, dtype=np.float32)
        t[M.MAE], t[M.WCE], t[M.ER] = self.mae, self.wce, self.er
        t[M.MRE], t[M.AVG] = self.mre, self.avg
        # boolean metrics: feasible iff value >= required level
        t[M.ACC0] = 1.0 if self.acc0 else -INF
        t[M.GAUSS] = 1.0 if self.gauss else -INF
        return t

    def describe(self) -> str:
        parts = []
        for name, v in (("mae", self.mae), ("wce", self.wce), ("er", self.er),
                        ("mre", self.mre), ("avg", self.avg)):
            if np.isfinite(v):
                parts.append(f"{name}<={v:g}%")
        if self.acc0:
            parts.append("acc0")
        if self.gauss:
            parts.append(f"gauss(sigma={self.gauss_sigma:g})")
        return "+".join(parts) if parts else "unconstrained"


# boolean metrics are lower-bounded, magnitude metrics upper-bounded
_IS_LOWER_BOUND = np.zeros((M.N_METRICS,), dtype=bool)
_IS_LOWER_BOUND[M.ACC0] = True
_IS_LOWER_BOUND[M.GAUSS] = True


def feasible(metric_vec: torch.Tensor, thresholds: torch.Tensor
             ) -> torch.Tensor:
    """Eq. (9) predicate over the last dim: ∧_i error_i ≤ T_i (≥ for the
    required booleans).  Leading dims broadcast."""
    lb = torch.as_tensor(_IS_LOWER_BOUND, device=metric_vec.device)
    ok = torch.where(lb, metric_vec >= thresholds, metric_vec <= thresholds)
    return ok.all(dim=-1)


def fitness(cost: torch.Tensor, metric_vec: torch.Tensor,
            thresholds: torch.Tensor) -> torch.Tensor:
    """Eq. (8)/(9): cost if all constraints hold else +inf."""
    return torch.where(feasible(metric_vec, thresholds), cost, INF)
