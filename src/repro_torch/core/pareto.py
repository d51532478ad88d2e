"""Pareto-front utilities for the trade-off analyses (paper Figs. 7-14).

The port's copy of ``repro.core.pareto`` (numpy only): the same masks and
values.  Besides the front and hypervolume primitives it holds the
analysis end of the sweep results path: cross-metric correlation matrices
(Fig. 6) and per-metric power-vs-error fronts (Figs. 7-14) over stacked
``(n_runs, N_METRICS)`` summary columns.  The in-RAM
``sweep.SweepResult`` and the on-disk ``results.SweepResultReader`` feed
these functions the same arrays, so the two give identical answers.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def pareto_front(points: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows (all objectives minimized).

    Args:
      points: (N, K) array; NaN/inf rows are never selected.
    """
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    ok = np.isfinite(pts).all(axis=1)
    mask = np.zeros(n, dtype=bool)
    order = np.argsort(pts[:, 0], kind="stable")
    for i in order:
        if not ok[i]:
            continue
        dominated = False
        for j in np.flatnonzero(mask):
            if (pts[j] <= pts[i]).all() and (pts[j] < pts[i]).any():
                dominated = True
                break
        if not dominated:
            # remove points the new one dominates
            for j in np.flatnonzero(mask):
                if (pts[i] <= pts[j]).all() and (pts[i] < pts[j]).any():
                    mask[j] = False
            mask[i] = True
    return mask


def pareto_points(points: np.ndarray) -> np.ndarray:
    """Sorted (by first column) non-dominated subset."""
    m = pareto_front(points)
    sel = np.asarray(points)[m]
    return sel[np.argsort(sel[:, 0])]


def metric_correlations(metrics: np.ndarray) -> np.ndarray:
    """|Pearson| correlation across metric columns (paper Fig. 6).

    Args:
      metrics: (N, K) stacked per-run metric vectors, one column per metric
        in ``metrics.METRIC_NAMES`` order — ``SweepResult.metrics[mask]`` or
        the ``"metrics"`` column of ``results.SweepResultReader.summary()``
        (``SweepResultReader.correlations`` does the masking for you).
    Returns:
      (K, K) symmetric float64 matrix with unit diagonal.  Zero-variance
      columns and N < 3 give zero off-diagonals instead of NaNs (a constant
      metric is uninformative, not perfectly correlated).
    """
    X = np.asarray(metrics, dtype=np.float64)
    k = X.shape[1] if X.ndim == 2 else 0
    if X.ndim != 2 or X.shape[0] < 3:
        return np.eye(k)
    with np.errstate(invalid="ignore", divide="ignore"):
        C = np.abs(np.corrcoef(X.T))
    C = np.nan_to_num(C, nan=0.0)
    np.fill_diagonal(C, 1.0)
    return C


def sweep_fronts(power: np.ndarray, metrics: np.ndarray,
                 metric_indices: Sequence[int]) -> dict[int, np.ndarray]:
    """Power-vs-metric Pareto fronts of a sweep (paper Figs. 7-14 axes).

    Args:
      power:   (N,) relative power per run (``power(C)/power(G)``).
      metrics: (N, K) final metric vectors per run, columns in
        ``metrics.METRIC_NAMES`` order.
      metric_indices: which metric columns to build fronts for (e.g.
        ``(metrics.MAE, metrics.ER)``).
    Returns:
      {metric index: (M, 2) front of (power_rel, metric value) points,
      sorted by power} — both objectives minimized; rows with NaN/inf never
      enter a front.
    """
    power = np.asarray(power, dtype=np.float64)
    metrics = np.asarray(metrics, dtype=np.float64)
    return {int(i): pareto_points(np.stack([power, metrics[:, i]], axis=1))
            for i in metric_indices}


def hypervolume_2d(points: np.ndarray, ref: tuple[float, float]) -> float:
    """2-D hypervolume (both objectives minimized) w.r.t. reference point."""
    front = pareto_points(points)
    front = front[(front[:, 0] <= ref[0]) & (front[:, 1] <= ref[1])]
    if front.size == 0:
        return 0.0
    hv, prev_y = 0.0, ref[1]
    for x, y in front:
        hv += (ref[0] - x) * (prev_y - y)
        prev_y = y
    return float(hv)
