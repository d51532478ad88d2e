"""The judge of one sweep generation, and its control.

``judge`` takes a sample of runs' states before and after the program's
last generation, works out with ``circuit`` what that generation must
give, and returns the numbers compared (the largest over the sample) and
the runs that read past a limit.  ``control`` is the reference put in the
program's place at a lower precision: it computes the same generation with
every metric and power rounded to ``dtype``, which must fail the judge.

States are dicts of NumPy arrays over the sampled runs: ``key`` (S, 2)
uint32, ``nodes`` (S, n_n, 3), ``outs`` (S, n_o), ``fit`` and ``best_fit``
(S,), and after the generation also ``metrics`` (S, 7) and ``power``
(S,).
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import circuit as C

# thresholds are met within this relative slack either way: a candidate
# whose metric lies this close to a threshold may be judged feasible or
# not, and either choice is right.  The program sums the errors of 2^16
# inputs into float32 bit by bit (16 roundings of ~6e-8): 1e-6 of a sum at
# most, so 4e-6 of the metric's scale (``circuit.scale``)
SLACK = 4e-6
# fitnesses (powers) this close, relatively, may be ordered either way:
# the program holds power in float32, 1.3e-7 from the reference at most.
# Fitnesses the reference finds equal are equal in the program too (the
# same active gates give the same sum), and are a tie.
TIE = 1e-6


def _rel(value, lo, hi):
    """Relative distance of ``value`` from the interval [lo, hi]: 0
    inside, inf where the bound it crosses or the value is infinite (a
    feasible reading against an infeasible one)."""
    value, lo, hi = (np.asarray(x, np.float64) for x in (value, lo, hi))

    def past(a, b):         # how far a lies past b, where a > b
        finite = np.isfinite(a) & np.isfinite(b)
        with np.errstate(invalid="ignore", divide="ignore"):
            d = np.where(finite, (a - b) / np.abs(np.where(finite, b, 1.0)),
                         np.inf)
        return np.where(a > b, d, 0.0)
    return np.maximum(past(lo, value), past(value, hi))


def allowed(f_lo: np.ndarray, f_hi: np.ndarray) -> np.ndarray:
    """(S, λ+1) bool: the candidates (0 the parent kept, k the k-th
    offspring taken) that the (1+λ) rule may make the new parent, given
    each candidate's fitness between its most and least feasible readings
    (``f_lo``, ``f_hi``; the parent's as the reference works it out).
    The rule: the first offspring of least fitness replaces the parent
    where it is <= the parent's (neutral drift).  Offspring k may be taken
    where some reading puts it below every earlier offspring, at most every
    later one and at most the parent; the parent may stay where some
    reading puts every offspring above it.  Equal readings that no
    threshold puts in doubt are a tie, never an order."""
    sure = f_lo == f_hi
    lo, hi = f_lo * (1 - TIE), f_hi * (1 + TIE)
    # [s, a, b]: a may lie below b / at most b
    tie = sure[:, :, None] & sure[:, None, :] & (
        f_lo[:, :, None] == f_lo[:, None, :])
    below = (lo[:, :, None] < hi[:, None, :]) & ~tie
    at_most = lo[:, :, None] <= hi[:, None, :]
    lam = f_lo.shape[1] - 1
    earlier = np.tri(lam, k=-1, dtype=bool)          # [k, m]: m < k
    first = np.where(earlier, below[:, 1:, 1:], at_most[:, 1:, 1:]).all(-1)
    take = first & at_most[:, 1:, 0]
    keep = below[:, 0, 1:].all(-1)
    return np.concatenate([keep[:, None], take], 1)


def candidates(problem: C.Problem, pre: dict, lam: int, rate: float):
    """(next keys, candidate nodes (S, λ+1, n_n, 3) and outs, their
    metrics (S, λ+1, 7) and power (S, λ+1)): the parent first, then its λ
    offspring."""
    key, on, oo = C.offspring(pre["key"], pre["nodes"], pre["outs"],
                              problem.n_i, problem.n_funcs, lam, rate)
    cn = np.concatenate([pre["nodes"][:, None], on], 1)
    co = np.concatenate([pre["outs"][:, None], oo], 1)
    S, K = cn.shape[:2]
    mets, pows = problem.evaluate(cn.reshape(S * K, *cn.shape[2:]),
                                  co.reshape(S * K, -1))
    return key, cn, co, mets.reshape(S, K, -1), pows.reshape(S, K)


def judge(problem: C.Problem, pre: dict, post: dict, thr: np.ndarray,
          lam: int, rate: float) -> dict:
    """Per sampled run: ``key_mismatch`` (the next key is not the split's),
    ``foreign_parent`` (the new parent is neither the old one nor an
    offspring), ``selection_mismatch`` (it is not a candidate that the
    (1+λ) rule may pick, ``allowed``), ``metric_gap`` and ``power_gap``
    (the new parent's reported metrics and power against the reference's,
    relative), ``fitness_gap`` (its reported fitness and the best-ever
    fitness against the reference's, relative).  Returns {name: (S,)
    array}."""
    key, cn, co, mets, pows = candidates(problem, pre, lam, rate)
    S = len(key)
    rows = np.arange(S)
    same = ((cn == post["nodes"][:, None]).all((-1, -2))
            & (co == post["outs"][:, None]).all(-1))
    j = same.argmax(1)
    t = thr[:, None]
    f_lo = C.fitness(mets, pows, t, SLACK)      # most feasible reading
    f_hi = C.fitness(mets, pows, t, -SLACK)     # least feasible reading
    m_ref, p_ref = mets[rows, j], pows[rows, j]
    with np.errstate(invalid="ignore", divide="ignore"):
        metric_gap = np.abs(post["metrics"] - m_ref) / np.maximum(
            C.scale(m_ref), 1e-12)
        # GAUSS compares integer counts with real bounds n·mass, which at
        # n = 2^16 lie 0.076 or more from an integer in float64 and
        # float32 alike: the two readings agree
        power_gap = np.abs(post["power"] - p_ref) / p_ref
    own = _rel(post["fit"], f_lo[rows, j], f_hi[rows, j])
    best = _rel(post["best_fit"],
                np.minimum(pre["best_fit"], f_lo[:, 1:].min(1)),
                np.minimum(pre["best_fit"], f_hi[:, 1:].min(1)))
    return {
        "key_mismatch": (post["key"] != key).any(-1).astype(float),
        "foreign_parent": (~same.any(1)).astype(float),
        "selection_mismatch": (~(same & allowed(f_lo, f_hi)).any(1))
        .astype(float),
        "metric_gap": np.nan_to_num(metric_gap.max(1), nan=np.inf),
        "power_gap": np.nan_to_num(power_gap, nan=np.inf),
        "fitness_gap": np.maximum(own, best),
    }


def control(problem: C.Problem, pre: dict, thr: np.ndarray, lam: int,
            rate: float, dtype=torch.bfloat16) -> dict:
    """The generation as the reference computes it with every metric,
    power and fitness it holds rounded to ``dtype``: the state after it,
    as the program would report."""
    key, cn, co, mets, pows = candidates(problem, pre, lam, rate)
    rnd = lambda x: torch.as_tensor(x, dtype=torch.float32).to(dtype).to(
        torch.float64).numpy()
    mets, pows = rnd(mets), rnd(pows)
    pre = dict(pre, metrics=rnd(pre["metrics"]), power=rnd(pre["power"]),
               fit=rnd(pre["fit"]), best_fit=rnd(pre["best_fit"]))
    fits = C.fitness(mets[:, 1:], pows[:, 1:], thr[:, None])
    S = len(key)
    rows = np.arange(S)
    i = fits.argmin(1)
    take = fits[rows, i] <= pre["fit"]
    pick = lambda new, old: np.where(
        take.reshape(-1, *([1] * (old.ndim - 1))), new, old)
    return {"key": key,
            "nodes": pick(cn[rows, i + 1], pre["nodes"]),
            "outs": pick(co[rows, i + 1], pre["outs"]),
            "metrics": pick(mets[rows, i + 1], pre["metrics"]),
            "power": pick(pows[rows, i + 1], pre["power"]),
            "fit": pick(fits[rows, i], pre["fit"]),
            "best_fit": np.minimum(pre["best_fit"], fits[rows, i])}
