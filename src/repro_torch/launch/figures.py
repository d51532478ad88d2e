"""The paper's figure pipeline on the PyTorch/CUDA port: one experiment
per paper figure (Figs. 5-12 and 14), each sliced from a shared sweep grid.

  PYTHONPATH=src python -m repro_torch.launch.figures --out-dir D
  PYTHONPATH=src python -m repro_torch.launch.figures --out-dir D \
      --width 8 --gens 1200 --seeds 3 --only fig6,fig14

Runs on the card; ``--device cpu`` runs the plain PyTorch path instead (at
a tiny budget: ``--width 3 --gens 20 --seeds 1``).  The paper gives every
CGP run an hour on a 14-core Xeon (~10^6 evaluations); the default budget
(``FigureBudget``: width 6, 1200 generations, λ = 8, 3 seeds, chunks of 32
runs) is ``benchmarks/paper_figures.py``'s.  What must reproduce is each
figure's *qualitative* claim (ER antagonism, ACC0 ~free, combined ER+MAE
/ WCE winning globally, ...): every figure function returns rows AND a
``claims`` dict of booleans checked against the paper's statements, with
the JAX package's logic copied as it is.

Execution model: every figure but Fig. 14 declares its constraint list up
front; their union, deduplicated, is ONE grid run once through
``search.run_sweep`` with streaming result shards (``keep_history=
"summary"``, under ``<out-dir>/grids/``), and each figure slices its rows
from the ``SweepResultReader``.  A run depends only on its (constraint,
seed) pair, so the slices equal what per-figure sweeps would give.  Fig. 14
runs its own grid (8-bit, 2.5x the generations, one seed) through the same
machinery.  The shard directories are named as the JAX package names them
(``grids/{tag}-{fingerprint[:12]}-c{chunk}``), so either package resumes,
or reads without a launch, a pass the other wrote.

Prints one ``name,us_per_call,derived`` CSV row per figure with
``claims_ok=``, and ``# paper-claim check: n/9 ...``; writes each figure's
JSON and ``claims_summary.json`` into ``--out-dir``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from repro_torch.core import metrics as M
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.pareto import hypervolume_2d, metric_correlations
from repro_torch.core.results import SweepResultReader
from repro_torch.core.search import CircuitRecord, SearchConfig, run_sweep
from repro_torch.core.sweep import SweepConfig, grid_fingerprint, sweep_grid
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class FigureBudget:
    """The reduced budget of a figure pass (the full paper protocol would
    be width 8, 400 nodes, ~10^6 evaluations a run)."""
    width: int = 6
    gens: int = 1200
    lam: int = 8
    seeds: int = 3
    chunk: int = 32

    @property
    def nodes(self) -> int:
        return 400 if self.width >= 8 else 250

    @property
    def seed_list(self) -> tuple:
        return tuple(range(self.seeds))

    def config(self, gens: int | None = None,
               width: int | None = None) -> SearchConfig:
        """The reference's ``_cfg``: the budget's problem unless overridden
        (400 nodes at width >= 8)."""
        w = width or self.width
        return SearchConfig(
            width=w, n_n=400 if w >= 8 else self.nodes,
            evolve=EvolveConfig(generations=gens or self.gens, lam=self.lam))


# --------------------------------------------------------------------------
# Per-figure constraint declarations (the shared grid is their union)
# --------------------------------------------------------------------------

FIG5_CONS = [ConstraintSpec(avg=t) for t in (0.01, 0.1, 1.0)]
FIG6_WCE = [ConstraintSpec(wce=t) for t in (0.1, 0.5, 1.0, 2.0, 5.0)]
FIG6_MAE = [ConstraintSpec(mae=t) for t in (0.05, 0.1, 0.5, 1.0, 2.0)]
FIG7_SWEEPS = {
    "mae": [ConstraintSpec(mae=t) for t in (0.05, 0.2, 0.5, 1.0, 2.0)],
    "wce": [ConstraintSpec(wce=t) for t in (0.2, 0.5, 1.0, 2.0, 5.0)],
    "er": [ConstraintSpec(er=t) for t in (10, 25, 50, 75, 90)],
    "mre": [ConstraintSpec(mre=t) for t in (1, 5, 10, 25, 50)],
}
FIG8_TS = (0.2, 0.5, 1.0, 2.0)
FIG8_PLAIN = [ConstraintSpec(wce=t) for t in FIG8_TS]
FIG8_ACC0 = [ConstraintSpec(wce=t, acc0=True) for t in FIG8_TS]
FIG9_TS = (0.5, 1.0, 2.0)
FIG9_PLAIN = [ConstraintSpec(wce=t) for t in FIG9_TS]
FIG9_TIGHT = [ConstraintSpec(wce=t, avg=0.01) for t in FIG9_TS]
FIG9_LOOSE = [ConstraintSpec(wce=t, avg=0.2) for t in FIG9_TS]
FIG10_COMBOS = ([ConstraintSpec(er=e, mae=m) for e in (30, 50, 70)
                 for m in (0.2, 1.0)] +
                [ConstraintSpec(er=e, wce=w) for e in (30, 50, 70)
                 for w in (0.5, 2.0)])
FIG11_CONS = [ConstraintSpec(wce=w, mre=m)
              for w in (0.5, 2.0) for m in (2.0, 10.0, 50.0)]
FIG12_MAE_AVG = [ConstraintSpec(mae=m, avg=0.05) for m in (0.2, 0.5, 1.0)]

FIG14_STRATEGIES = {
    "mae": [ConstraintSpec(mae=t) for t in (0.2, 0.5, 1.5)],
    "wce": [ConstraintSpec(wce=t) for t in (0.5, 2.0, 5.0)],
    "er": [ConstraintSpec(er=t) for t in (30, 50, 70)],
    "mre": [ConstraintSpec(mre=t) for t in (5, 10, 25)],
    "er+mae": [ConstraintSpec(er=e, mae=m)
               for e in (50, 70) for m in (0.5, 1.5)],
    "er+wce": [ConstraintSpec(er=e, wce=w)
               for e in (50, 70) for w in (2.0, 5.0)],
}


def fig12_gauss_constraints(width: int) -> list[ConstraintSpec]:
    """``FIG12_GAUSS`` at ``width``: its σ scale (``_SIGMA_REL``) is 4 at
    width 8, else 1."""
    sigma_rel = {6: 1.0, 8: 4.0}.get(width, 1.0)
    return [ConstraintSpec(wce=w, gauss=True, gauss_sigma=s * sigma_rel)
            for w in (1.0, 2.0) for s in (2.0, 8.0)]


def fig14_constraints() -> list[ConstraintSpec]:
    """Fig. 14's grid: every strategy's constraints, in strategy order."""
    return [c for cs in FIG14_STRATEGIES.values() for c in cs]


def shared_constraints(width: int) -> list[ConstraintSpec]:
    """Deduplicated union of every shared-grid figure's constraints at
    ``width``, in first-appearance order (the grid's run order), keyed on
    (``describe()``, ``gauss_sigma``)."""
    groups = ([FIG5_CONS, FIG6_WCE, FIG6_MAE] + list(FIG7_SWEEPS.values())
              + [FIG8_PLAIN, FIG8_ACC0, FIG9_PLAIN, FIG9_TIGHT, FIG9_LOOSE,
                 FIG10_COMBOS, FIG11_CONS, fig12_gauss_constraints(width),
                 FIG12_MAE_AVG])
    out, seen = [], set()
    for cons in groups:
        for c in cons:
            key = (c.describe(), float(c.gauss_sigma))
            if key not in seen:
                seen.add(key)
                out.append(c)
    return out


# --------------------------------------------------------------------------
# Grid execution (run once, slice per figure from the reader)
# --------------------------------------------------------------------------

class FigureRun:
    """One figure pass: its budget, output directory and device, and the
    readers of the grids it ran (the reference's module-level
    ``_READER_CACHE`` / ``_RECORD_INDEX``, held here instead)."""

    def __init__(self, budget: FigureBudget, out_dir: str,
                 device: str = "cuda"):
        self.budget = budget
        self.out_dir = out_dir
        self.device = device
        self.readers: dict[str, SweepResultReader] = {}
        self._index: dict[str, dict] = {}

    def grid_reader(self, tag: str, cfg: SearchConfig,
                    constraints: list[ConstraintSpec],
                    seeds: tuple) -> SweepResultReader:
        """Run a grid once through the streaming results layer and return
        its reader; an identical rerun, or an interrupted pass, resumes
        from the committed shards.  The directory is
        ``grids/{tag}-{fp[:12]}-c{chunk}``: the grid fingerprint gives a
        budget or code change a fresh one, and the chunk size, pinned in
        the shard manifest, sits beside it."""
        fp = grid_fingerprint(cfg, sweep_grid(constraints, seeds), "summary")
        rdir = os.path.join(self.out_dir, "grids",
                            f"{tag}-{fp[:12]}-c{self.budget.chunk}")
        if rdir not in self.readers:
            run_sweep(cfg, constraints, seeds=seeds,
                      sweep=SweepConfig(chunk_size=self.budget.chunk,
                                        keep_history="summary",
                                        results_dir=rdir),
                      device=self.device)
            self.readers[rdir] = SweepResultReader(rdir)
        return self.readers[rdir]

    def shared_reader(self) -> SweepResultReader:
        """The ONE grid behind Figs. 5-12 at the budget."""
        b = self.budget
        return self.grid_reader("shared", b.config(),
                                shared_constraints(b.width), b.seed_list)

    def fig14_reader(self) -> SweepResultReader:
        """Fig. 14's own grid: the paper's operating point (8x8, 400 nodes)
        at 2.5x the generations, the first seed."""
        b = self.budget
        return self.grid_reader("fig14",
                                b.config(gens=int(2.5 * b.gens), width=8),
                                fig14_constraints(), b.seed_list[:1])

    def select(self, reader: SweepResultReader,
               constraints: list[ConstraintSpec],
               seeds: tuple | None = None) -> list[CircuitRecord]:
        """A figure's records out of a grid reader, in the order a
        dedicated ``run_sweep(constraints, seeds)`` would return them; the
        (constraint, seed) index is built once a grid directory."""
        seeds = self.budget.seed_list if seeds is None else seeds
        if reader.results_dir not in self._index:
            self._index[reader.results_dir] = {
                (r.constraint, r.seed): r for r in reader.records()}
        index = self._index[reader.results_dir]
        return [index[(c.describe(), s)] for c in constraints for s in seeds]

    def save(self, name: str, rows: list[dict], claims: dict,
             reader: SweepResultReader) -> dict:
        """``<out_dir>/<name>.json``, stamped with the budget and the grid's
        fingerprint (the shared budget's, Fig. 14's too, as the reference
        stamps them)."""
        b = self.budget
        os.makedirs(self.out_dir, exist_ok=True)
        out = {"figure": name, "width": b.width, "gens": b.gens,
               "lam": b.lam, "grid_fingerprint": reader.fingerprint,
               "budget": {"width": b.width, "gens": b.gens, "lam": b.lam,
                          "seeds": b.seeds, "nodes": b.nodes,
                          "chunk": b.chunk},
               "rows": rows, "claims": claims}
        with open(os.path.join(self.out_dir, f"{name}.json"), "w") as f:
            json.dump(out, f, indent=1)
        return out


def _rows(recs: list[CircuitRecord]) -> list[dict]:
    return [{"constraint": r.constraint, "seed": r.seed,
             "power_rel": r.power_rel, "feasible": r.feasible,
             "mae": float(r.metrics[M.MAE]), "wce": float(r.metrics[M.WCE]),
             "er": float(r.metrics[M.ER]), "mre": float(r.metrics[M.MRE]),
             "avg": float(r.metrics[M.AVG]),
             "acc0": float(r.metrics[M.ACC0]),
             "err_std": r.error_std, "err_mean": r.error_mean}
            for r in recs]


# --------------------------------------------------------------------------
# The figures: each takes the run and its grid's reader.  The claims logic
# is the JAX package's, quirks included (ROADMAP, facts about the
# reference).
# --------------------------------------------------------------------------

def fig5_avg_only(run: FigureRun, grid: SweepResultReader) -> dict:
    """Fig. 5: constraining ONLY the average error degenerates the
    circuit."""
    rows = _rows(run.select(grid, FIG5_CONS))
    # degenerate: massive power reduction with terrible WCE/MAE
    deg = [r for r in rows if r["feasible"] and r["power_rel"] < 0.4]
    claims = {
        "avg_only_removes_most_logic": len(deg) > 0,
        "avg_only_wce_useless": all(r["wce"] > 5.0 for r in deg) if deg
        else False,
    }
    return run.save("fig5_avg_only", rows, claims, grid)


def fig6_correlations(run: FigureRun, grid: SweepResultReader) -> dict:
    """Fig. 6: metric correlations in WCE- vs MAE-constrained circuits."""
    wce_recs = run.select(grid, FIG6_WCE)
    mae_recs = run.select(grid, FIG6_MAE)

    def corr_matrix(recs):
        cols = [M.MAE, M.WCE, M.ER, M.MRE, M.AVG]
        X = np.array([[r.metrics[c] for c in cols] for r in recs])
        if len(recs) < 3:
            return None
        return metric_correlations(X)

    cw = corr_matrix(wce_recs)
    cm = corr_matrix(mae_recs)
    names = ["mae", "wce", "er", "mre", "avg"]
    rows = ([{"set": "wce", "matrix": cw.tolist(), "names": names}]
            + [{"set": "mae", "matrix": cm.tolist(), "names": names}]
            + _rows(wce_recs + mae_recs))
    # paper: under MAE constraints, WCE stays within ~3.2x MAE; the check
    # is "same order of magnitude", the measured max ratio is data
    mae_feas = [r for r in _rows(mae_recs) if r["feasible"]
                and r["mae"] > 1e-4]
    ratio = max((r["wce"] / r["mae"] for r in mae_feas), default=0.0)
    claims = {
        "wce_set_correlates_mae_wce": bool(cw is not None
                                           and cw[0, 1] > 0.6),
        # the argmin term is never None, so only the second term decides
        "er_least_correlated_in_wce_set": bool(
            cw is not None and
            np.argmin([cw[2, j] for j in (0, 1, 3, 4)]) is not None and
            cw[0, 2] <= max(cw[0, 1], cw[0, 3]) + 1e-9),
        "wce_within_order_of_paper_3.2x_bound": bool(0 < ratio <= 32.0),
        "max_wce_over_mae_ratio": float(ratio),
    }
    return run.save("fig6_correlations", rows, claims, grid)


def fig7_single_metric_tradeoffs(run: FigureRun,
                                 grid: SweepResultReader) -> dict:
    """Figs. 2/7: single-metric objectives do NOT give global quality; ER
    is antagonistic to the other metrics."""
    all_rows = []
    by_obj = {}
    for obj, cons in FIG7_SWEEPS.items():
        rows = _rows(run.select(grid, cons))
        for r in rows:
            r["objective"] = obj
        by_obj[obj] = [r for r in rows if r["feasible"]]
        all_rows += rows

    def hv(rows, metric):
        pts = np.array([[r["power_rel"], r[metric]] for r in rows]) \
            if rows else np.zeros((0, 2))
        ref = {"mae": (1.05, 25.0), "er": (1.05, 100.0)}[metric]
        return hypervolume_2d(pts, ref)

    # ER-optimized circuits dominate the power-ER trade-off...
    hv_er_on_er = hv(by_obj["er"], "er")
    hv_mae_on_er = hv(by_obj["mae"], "er")
    # ...but are poor on MAE, and vice versa
    hv_mae_on_mae = hv(by_obj["mae"], "mae")
    hv_er_on_mae = hv(by_obj["er"], "mae")
    claims = {
        "er_objective_best_for_er": hv_er_on_er > hv_mae_on_er,
        "mae_objective_best_for_mae": hv_mae_on_mae > hv_er_on_mae,
        "hv_er_on_er": hv_er_on_er, "hv_mae_on_er": hv_mae_on_er,
        "hv_mae_on_mae": hv_mae_on_mae, "hv_er_on_mae": hv_er_on_mae,
    }
    return run.save("fig7_single_metric_tradeoffs", all_rows, claims, grid)


def fig8_acc0(run: FigureRun, grid: SweepResultReader) -> dict:
    """Fig. 8: adding ACC0 is (almost) free."""
    plain = run.select(grid, FIG8_PLAIN)
    with0 = run.select(grid, FIG8_ACC0)
    rows = _rows(plain) + _rows(with0)
    p_med = np.median([r.power_rel for r in plain if r.feasible])
    a_med = np.median([r.power_rel for r in with0 if r.feasible])
    claims = {
        "acc0_cost_below_5pct": bool(abs(a_med - p_med) < 0.05),
        "median_power_plain": float(p_med),
        "median_power_acc0": float(a_med),
        "all_acc0_circuits_exact_on_zero": all(
            r.metrics[M.ACC0] == 1 for r in with0 if r.feasible),
    }
    return run.save("fig8_acc0", rows, claims, grid)


def _median_power(recs) -> float:
    """Median power of the feasible records; 1.0 when none is."""
    return float(np.median([r.power_rel for r in recs if r.feasible])
                 if any(r.feasible for r in recs) else 1.0)


def fig9_wce_avg(run: FigureRun, grid: SweepResultReader) -> dict:
    """Fig. 9: WCE + AVG costs power when AVG is tight."""
    plain = run.select(grid, FIG9_PLAIN)
    tight = run.select(grid, FIG9_TIGHT)
    loose = run.select(grid, FIG9_LOOSE)
    rows = _rows(plain) + _rows(tight) + _rows(loose)
    med = _median_power
    claims = {
        "tight_avg_costs_power": med(tight) >= med(plain) - 0.01,
        "power_plain": med(plain), "power_avg_tight": med(tight),
        "power_avg_loose": med(loose),
    }
    return run.save("fig9_wce_avg", rows, claims, grid)


def fig10_er_combos(run: FigureRun, grid: SweepResultReader) -> dict:
    """Fig. 10: combining ER with MAE/WCE; the ER constraint caps the
    achievable MAE."""
    rows = _rows(run.select(grid, FIG10_COMBOS))
    # paper: with ER<=30 the MAE stays low even when unconstrained-ish
    er30 = [r for r in rows if r["feasible"] and "er<=30" in r["constraint"]]
    claims = {
        "er_constraint_caps_mae": all(r["mae"] < 5.0 for r in er30)
        if er30 else False,
        "feasible_fraction": float(np.mean([r["feasible"] for r in rows])),
    }
    return run.save("fig10_er_combos", rows, claims, grid)


def fig11_wce_mre(run: FigureRun, grid: SweepResultReader) -> dict:
    """Fig. 11: WCE + MRE trade-offs."""
    rows = _rows(run.select(grid, FIG11_CONS))
    # the bounds are the loosest thresholds of the grid, for every row
    claims = {"all_respect_both": all(
        (r["wce"] <= 2.0 + 1e-3 and r["mre"] <= 50 + 1e-3)
        for r in rows if r["feasible"])}
    return run.save("fig11_wce_mre", rows, claims, grid)


def fig12_gauss(run: FigureRun, grid: SweepResultReader) -> dict:
    """Figs. 12/13: the Gauss_σ constraint is hard for CGP; MAE+AVG runs
    give near-gaussian error distributions more cheaply."""
    gauss = run.select(grid, fig12_gauss_constraints(run.budget.width))
    mae_avg = run.select(grid, FIG12_MAE_AVG)
    rows = _rows(gauss) + [dict(r, set="mae_avg") for r in _rows(mae_avg)]
    med = _median_power
    claims = {
        "gauss_lower_reduction_than_mae_avg": med(gauss) >= med(mae_avg),
        "power_gauss": med(gauss), "power_mae_avg": med(mae_avg),
        "mae_avg_near_zero_mean": all(
            abs(r.error_mean) < 50 for r in mae_avg if r.feasible),
    }
    return run.save("fig12_gauss", rows, claims, grid)


def fig14_global_pareto(run: FigureRun, grid: SweepResultReader) -> dict:
    """Global comparison (paper Figs. 1/14).  The paper's statements: (i)
    combined ER+MAE / ER+WCE give "almost optimal trade-offs for the ER and
    MRE"; (ii) "for the MAE and WCE, the circuits slightly lag behind the
    best" but remain good; (iii) ER-only is far from optimal on MAE/WCE;
    (iv) "surprisingly, the single MRE constraint provides very good
    trade-offs across the remaining metrics" when ER is not needed.  The
    grid is the paper's operating point (8x8, 400 nodes, the 2^16 cube) at
    2.5x the generations, one seed."""
    rows = []
    hv = {}
    for name, cons in FIG14_STRATEGIES.items():
        rs = _rows(run.select(grid, cons, seeds=run.budget.seed_list[:1]))
        for r in rs:
            r["strategy"] = name
        rows += rs
        feas = [r for r in rs if r["feasible"]]
        for metric, ref in (("mae", (1.05, 25.0)), ("wce", (1.05, 60.0)),
                            ("er", (1.05, 100.0)), ("mre", (1.05, 100.0))):
            pts = np.array([[r["power_rel"], r[metric]] for r in feas]) \
                if feas else np.zeros((0, 2))
            hv[f"{name}|{metric}"] = hypervolume_2d(pts, ref)

    def norm(name, metric):
        best = max(hv[f"{s}|{metric}"] for s in FIG14_STRATEGIES) or 1.0
        return hv[f"{name}|{metric}"] / best

    scores = {n: float(np.mean([norm(n, m) for m in
                                ("mae", "wce", "er", "mre")]))
              for n in FIG14_STRATEGIES}

    # at each ER level, the ER+MAE/ER+WCE circuit matches the ER-only
    # circuit's power (within a few %) while improving MAE/WCE/MRE by
    # large factors
    feas = [r for r in rows if r["feasible"]]
    dominate_checks = []
    for er_t in (50, 70):
        er_only = [r for r in feas if r["strategy"] == "er"
                   and r["er"] <= er_t + 0.5]
        combos = [r for r in feas if r["strategy"] in ("er+mae", "er+wce")
                  and r["er"] <= er_t + 0.5]
        if not er_only or not combos:
            continue
        base = min(er_only, key=lambda r: r["power_rel"])
        best = min(combos, key=lambda r: r["mae"])
        dominate_checks.append({
            "er_level": er_t,
            "power_delta": best["power_rel"] - base["power_rel"],
            "mae_improvement": base["mae"] / max(best["mae"], 1e-9),
            "wce_improvement": base["wce"] / max(best["wce"], 1e-9),
            "mre_improvement": base["mre"] / max(best["mre"], 1e-9),
            "ok": (best["power_rel"] <= base["power_rel"] + 0.03
                   and base["mae"] >= 2 * best["mae"]
                   and base["wce"] >= 2 * best["wce"]
                   and base["mre"] >= 1.5 * best["mre"]),
        })
    # antagonism: MAE/WCE-optimized circuits are useless on ER (Fig. 2)
    mae_ers = [r["er"] for r in feas if r["strategy"] in ("mae", "wce")]
    claims = {
        "combined_matches_er_only_power_and_dominates_other_metrics":
            bool(dominate_checks) and all(c["ok"] for c in dominate_checks),
        "dominate_checks": dominate_checks,
        "mae_wce_objectives_useless_on_er": bool(
            mae_ers and min(mae_ers) > 90.0),
        "er_only_poor_on_mae": norm("er", "mae") < 0.7,
        "mre_single_good_on_magnitude_metrics": (
            norm("mre", "mae") >= 0.3 and norm("mre", "wce") >= 0.15),
        "scores_mean": scores, "hypervolumes": hv,
    }
    return run.save("fig14_global_pareto", rows, claims, grid)


#: (short name, figure, grid) in the reference's order; the short names
#: are ``benchmarks/run.py``'s (``--only``)
FIGURES = (("fig5", fig5_avg_only, "shared"),
           ("fig6", fig6_correlations, "shared"),
           ("fig7", fig7_single_metric_tradeoffs, "shared"),
           ("fig8", fig8_acc0, "shared"),
           ("fig9", fig9_wce_avg, "shared"),
           ("fig10", fig10_er_combos, "shared"),
           ("fig11", fig11_wce_mre, "shared"),
           ("fig12", fig12_gauss, "shared"),
           ("fig14", fig14_global_pareto, "fig14"))


def claims_ok(claims: dict) -> bool:
    """A figure reproduces when every boolean claim holds."""
    return all(v for v in claims.values() if isinstance(v, bool))


#: row columns measured from integer partials: equal bit for bit wherever
#: two passes' genomes are equal
EXACT = frozenset({"mae", "wce", "er", "avg", "acc0"})
#: claims that sum or subtract powers: hypervolumes, the scores normalised
#: from them, and power differences
DERIVED = frozenset({"hv_er_on_er", "hv_mae_on_er", "hv_mae_on_mae",
                     "hv_er_on_mae", "hypervolumes", "scores_mean",
                     "power_delta"})
#: two sweeps' powers agree within RTOL; DERIVED claims over powers that
#: differ in their last float32 bits read up to 1.70e-6 relative apart
#: (Fig. 7's hypervolumes, width 3, tests/test_torch_figures.py)
RTOL, DERIVED_RTOL = 1e-6, 1e-5


def differences(got, want, rtol: float = RTOL, path: str = "") -> list:
    """The paths where two figure JSONs, or parts of them, differ: booleans,
    ints and strings exactly, floats within ``rtol`` (NaN equal to NaN;
    ``rtol=0`` is bit for bit).  At RTOL, the ``EXACT`` columns are held
    bit for bit and the ``DERIVED`` claims within DERIVED_RTOL."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or got.keys() != want.keys():
            return [path]
        out = []
        for k in want:
            r = rtol
            if rtol == RTOL and k in EXACT:
                r = 0.0
            elif rtol == RTOL and k in DERIVED:
                r = DERIVED_RTOL
            out += differences(got[k], want[k], r, f"{path}.{k}")
        return out
    if isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            return [path]
        return [p for i, (a, b) in enumerate(zip(got, want))
                for p in differences(a, b, rtol, f"{path}[{i}]")]
    if isinstance(want, float) and isinstance(got, float):
        same = np.isclose(got, want, rtol=rtol, atol=0, equal_nan=True)
        return [] if same else [path]
    return [] if type(got) is type(want) and got == want else [path]


def run_figures(run: FigureRun, only: set[str] | None = None,
                emit=print) -> dict:
    """Every figure (or those in ``only``) in order; emits the CSV rows and
    the closing claim-check line, writes ``claims_summary.json`` and
    returns it."""
    emit("name,us_per_call,derived")
    claims_all = {}
    for short, fn, grid in FIGURES:
        if only is not None and short not in only:
            continue
        t0 = time.perf_counter()
        reader = (run.fig14_reader() if grid == "fig14"
                  else run.shared_reader())
        out = fn(run, reader)
        dt = time.perf_counter() - t0
        claims_all[out["figure"]] = out["claims"]
        emit(f"{out['figure']},{1e6 * dt:.1f},"
             f"claims_ok={claims_ok(out['claims'])}")
    if claims_all:
        b = run.budget
        # stamped with the shard grids the figures were sliced from
        claims_all["_meta"] = {
            "grid_fingerprints": sorted(
                {d.rsplit(os.sep, 1)[-1] for d in run.readers}),
            "budget": {"width": b.width, "gens": b.gens, "lam": b.lam,
                       "seeds": b.seeds},
        }
        os.makedirs(run.out_dir, exist_ok=True)
        with open(os.path.join(run.out_dir, "claims_summary.json"),
                  "w") as f:
            json.dump(claims_all, f, indent=1, default=str)
        figs = {k: v for k, v in claims_all.items() if k != "_meta"}
        n_ok = sum(claims_ok(c) for c in figs.values())
        emit(f"# paper-claim check: {n_ok}/{len(figs)} figures "
             f"reproduce their qualitative claims")
    return claims_all


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-dir", required=True,
                    help="where the figure JSONs, claims_summary.json and "
                         "the grids' shard directories go")
    d = FigureBudget()
    ap.add_argument("--width", type=int, default=d.width)
    ap.add_argument("--gens", type=int, default=d.gens)
    ap.add_argument("--lam", type=int, default=d.lam)
    ap.add_argument("--seeds", type=int, default=d.seeds)
    ap.add_argument("--chunk", type=int, default=d.chunk,
                    help="runs a sweep chunk")
    ap.add_argument("--only", default=None,
                    help="comma list of " + ",".join(s for s, _, _ in
                                                     FIGURES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    unknown = (only or set()) - {s for s, _, _ in FIGURES}
    if unknown:
        ap.error(f"unknown figures {sorted(unknown)}")
    resolve_device(args.device)
    budget = FigureBudget(width=args.width, gens=args.gens, lam=args.lam,
                          seeds=args.seeds, chunk=args.chunk)
    return run_figures(FigureRun(budget, args.out_dir, args.device), only,
                       emit=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
