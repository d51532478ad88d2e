"""The port's figure pipeline (``repro_torch.launch.figures``) against the
JAX package's (``benchmarks/paper_figures.py`` and ``benchmarks/run.py``).

The reference reads its budget from ``REPRO_BENCH_*`` when it is imported,
so each use sets them and reloads it; its output directory is a temporary
one.  Both packages run the shared grid at width 3 on the CPU.  Rows and
claims compare as the port's slices do: feasibility and the integer
metrics bit for bit, the float columns (power, MRE, the error's mean and
std) and the float claims within rtol 1e-6, every boolean claim equal, and
the fingerprints and budgets equal.  Hypervolumes and power differences
(``figures.DERIVED``) sum or take differences of powers that agree within
float32 ulps, which moved them up to 1.70e-6 relative: across the two
sweeps they are held within ``figures.DERIVED_RTOL`` (1e-5).  Besides, every
figure of the port equals, bit for bit, the reference's figure function
run on the port's own shards: the claims logic is the reference's, and the
sweeps agree row by row.  ``figures.differences`` is the one comparison,
which ``chip_smoke.py`` holds the card's figures to as well."""
import importlib
import json
import os
import shutil
import sys

import pytest
import torch

from conftest import REPO
from repro_torch.kernels import ops
from repro_torch.launch import figures as T

WIDTH, GENS, LAM, SEEDS, CHUNK = 3, 16, 4, 1, 32
FIG14_GENS = 12                  # the small-width Fig. 14 grid's
SHARED = [s for s, _, g in T.FIGURES if g == "shared"]


def _reference(mp, out_dir, width=WIDTH, gens=GENS, lam=LAM, seeds=SEEDS,
               chunk=CHUNK):
    """``benchmarks.paper_figures`` reloaded at this budget, writing into
    ``out_dir``."""
    for k, v in dict(DIR=out_dir, WIDTH=width, GENS=gens, LAM=lam,
                     SEEDS=seeds, CHUNK=chunk).items():
        mp.setenv(f"REPRO_BENCH_{k}", str(v))
    mp.syspath_prepend(REPO)
    import benchmarks.paper_figures as PF
    return importlib.reload(PF)


def _budget(**kw) -> T.FigureBudget:
    return T.FigureBudget(**{**dict(width=WIDTH, gens=GENS, lam=LAM,
                                    seeds=SEEDS, chunk=CHUNK), **kw})


def _load(d: str) -> dict:
    return {f[:-5]: json.load(open(os.path.join(d, f)))
            for f in sorted(os.listdir(d)) if f.endswith(".json")}


def assert_same(got, want, path="", exact=False):
    """``got`` equals ``want`` as ``figures.differences`` holds two sweeps'
    figures, or with ``exact`` every float bit for bit."""
    apart = T.differences(got, want, 0.0 if exact else T.RTOL, path)
    assert apart == [], apart


@pytest.fixture(scope="module")
def reference_pass(tmp_path_factory):
    """The reference's eight shared-grid figures: (directory, JSONs)."""
    d = str(tmp_path_factory.mktemp("ref"))
    with pytest.MonkeyPatch.context() as mp:
        PF = _reference(mp, d)
        for fn in PF.ALL_FIGURES:
            if fn is not PF.fig14_global_pareto:
                fn()
    return d, _load(d)


@pytest.fixture(scope="module")
def port_pass(tmp_path_factory):
    """The port's eight shared-grid figures on its own sweep: (its shard
    directory, JSONs)."""
    d = str(tmp_path_factory.mktemp("port"))
    run = T.FigureRun(_budget(), d, "cpu")
    T.run_figures(run, set(SHARED), emit=lambda s: None)
    (grid,) = run.readers
    return grid, _load(d)


@pytest.fixture(scope="module")
def reference_on_port(tmp_path_factory, port_pass):
    """The reference's eight shared-grid figures on the port's shards."""
    d = str(tmp_path_factory.mktemp("ref_on_port"))
    with pytest.MonkeyPatch.context() as mp:
        PF = _reference(mp, d)
        mp.setattr(PF, "shared_reader",
                   lambda: PF.SweepResultReader(port_pass[0]))
        for fn in PF.ALL_FIGURES:
            if fn is not PF.fig14_global_pareto:
                fn()
    return _load(d)


@pytest.mark.parametrize("width", [3, 6, 8])
def test_constraint_grids_equal_the_reference(width, tmp_path, monkeypatch):
    PF = _reference(monkeypatch, str(tmp_path), width=width)

    def ids(cons):
        return [(c.describe(), float(c.gauss_sigma)) for c in cons]

    assert ids(T.shared_constraints(width)) == ids(PF.shared_constraints())
    for name in ("FIG5_CONS", "FIG6_WCE", "FIG6_MAE", "FIG8_PLAIN",
                 "FIG8_ACC0", "FIG9_PLAIN", "FIG9_TIGHT", "FIG9_LOOSE",
                 "FIG10_COMBOS", "FIG11_CONS", "FIG12_MAE_AVG"):
        assert ids(getattr(T, name)) == ids(getattr(PF, name)), name
    assert ids(T.fig12_gauss_constraints(width)) == ids(PF.FIG12_GAUSS)
    for table in ("FIG7_SWEEPS", "FIG14_STRATEGIES"):
        got, want = getattr(T, table), getattr(PF, table)
        assert list(got) == list(want)
        assert all(ids(got[k]) == ids(want[k]) for k in want), table
    b = _budget(width=width)
    assert b.nodes == PF.NODES
    for got, want in ((b.config(), PF._cfg()),
                      (b.config(gens=int(2.5 * b.gens), width=8),
                       PF._cfg(gens=int(2.5 * PF.GENS), width=8))):
        assert (got.width, got.kind, got.n_n) == (want.width, want.kind,
                                                  want.n_n)
        e, f = got.evolve, want.evolve
        assert (e.generations, e.lam, e.mutation_rate) == (
            f.generations, f.lam, f.mutation_rate)


@pytest.mark.parametrize("short", SHARED)
def test_shared_grid_figures_equal_the_reference(short, reference_pass,
                                                 port_pass,
                                                 reference_on_port):
    name = {s: f.__name__ for s, f, _ in T.FIGURES}[short]
    got, want = port_pass[1][name], reference_pass[1][name]
    assert got["grid_fingerprint"] == want["grid_fingerprint"]
    assert got["budget"] == want["budget"]
    assert_same(got, want, name)
    assert_same(got, reference_on_port[name], name, exact=True)


def test_pass_on_the_reference_shards_launches_nothing(reference_pass,
                                                       tmp_path, monkeypatch):
    """The port reads the reference's own shard directory, named as the
    reference names it, resumes it with no launch and writes the
    reference's JSONs."""
    ref_dir, want = reference_pass
    shutil.copytree(os.path.join(ref_dir, "grids"), tmp_path / "grids")
    calls = []
    real = ops.cgp_eval_batched
    monkeypatch.setattr(ops, "cgp_eval_batched",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    run = T.FigureRun(_budget(), str(tmp_path), "cpu")
    T.run_figures(run, set(SHARED), emit=lambda s: None)
    assert calls == []
    assert sorted(os.listdir(tmp_path / "grids")) == sorted(
        os.listdir(os.path.join(ref_dir, "grids")))
    got = _load(str(tmp_path))
    assert got.pop("claims_summary")["_meta"]["grid_fingerprints"] == \
        os.listdir(tmp_path / "grids")
    assert got.keys() == want.keys()
    for name in want:
        assert_same(got[name], want[name], name, exact=True)


@pytest.mark.parametrize("source", ["own grid", "reference shards"])
def test_fig14_equals_the_reference_on_a_small_grid(source, tmp_path,
                                                    monkeypatch):
    """Fig. 14's function of both packages on the same small-width grid
    (its width-8 grid takes minutes on the CPU)."""
    PF = _reference(monkeypatch, str(tmp_path / "ref"))
    cons = [c for cs in PF.FIG14_STRATEGIES.values() for c in cs]
    ref_reader = PF._grid_reader("fig14", PF._cfg(gens=FIG14_GENS),
                                 cons, PF.SEEDS[:1])
    monkeypatch.setattr(PF, "fig14_reader", lambda: ref_reader)
    want = PF.fig14_global_pareto()
    run = T.FigureRun(_budget(), str(tmp_path / "port"), "cpu")
    if source == "own grid":
        reader = run.grid_reader("fig14", run.budget.config(gens=FIG14_GENS),
                                 T.fig14_constraints(), (0,))
        assert os.path.basename(reader.results_dir) == os.path.basename(
            ref_reader.results_dir)
    else:
        reader = T.SweepResultReader(ref_reader.results_dir)
    got = T.fig14_global_pareto(run, reader)
    assert got["grid_fingerprint"] == want["grid_fingerprint"]
    got, want = (json.loads(json.dumps(x)) for x in (got, want))
    own = source == "own grid"
    assert_same(got, want, "fig14", exact=not own)
    assert _load(str(tmp_path / "port"))["fig14_global_pareto"] == got
    if own:     # the reference's logic on the port's shards: bit for bit
        monkeypatch.setattr(PF, "fig14_reader",
                            lambda: PF.SweepResultReader(reader.results_dir))
        assert_same(got, json.loads(json.dumps(PF.fig14_global_pareto())),
                    "fig14", exact=True)


def test_cli_writes_the_reference_claims_summary(reference_pass, tmp_path,
                                                 monkeypatch, capsys):
    """``python -m repro_torch.launch.figures`` against ``benchmarks/run.py``
    on the same shards: the same CSV names, claims and ``_meta``."""
    ref_dir, _ = reference_pass
    mine = tmp_path / "port"
    shutil.copytree(os.path.join(ref_dir, "grids"), mine / "grids")
    theirs = tmp_path / "ref"
    shutil.copytree(os.path.join(ref_dir, "grids"), theirs / "grids")
    only = ",".join(SHARED)
    T.main(["--out-dir", str(mine), "--width", str(WIDTH), "--gens",
            str(GENS), "--lam", str(LAM), "--seeds", str(SEEDS), "--chunk",
            str(CHUNK), "--only", only, "--device", "cpu"])
    got_out = capsys.readouterr().out.splitlines()
    _reference(monkeypatch, str(theirs))
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", ["run.py", "--only", only])
    import benchmarks.run as RUN
    RUN.main()
    want_out = capsys.readouterr().out.splitlines()
    assert [r.split(",")[0] for r in got_out] == [r.split(",")[0]
                                                  for r in want_out]
    assert [r.rsplit(",", 1)[-1] for r in got_out[1:]] == [
        r.rsplit(",", 1)[-1] for r in want_out[1:]]
    got = json.load(open(mine / "claims_summary.json"))
    want = json.load(open(theirs / "claims_summary.json"))
    assert got["_meta"] == want["_meta"]
    assert_same(got, want, "claims_summary", exact=True)


def test_cli_writes_all_nine_figures(tmp_path, monkeypatch, capsys):
    """At a tiny budget on the CPU the CLI writes the nine figure JSONs
    with the reference's keys and the summary with its ``_meta``."""
    T.main(["--out-dir", str(tmp_path), "--width", "2", "--gens", "1",
            "--lam", "2", "--seeds", "1", "--chunk", "32", "--device",
            "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert lines[-1].startswith("# paper-claim check: ")
    assert lines[-1].endswith("/9 figures reproduce their qualitative "
                              "claims")
    out = _load(str(tmp_path))
    names = [f.__name__ for _, f, _ in T.FIGURES]
    assert sorted(out) == sorted(names + ["claims_summary"])
    for name in names:
        assert list(out[name]) == ["figure", "width", "gens", "lam",
                                   "grid_fingerprint", "budget", "rows",
                                   "claims"]
        assert out[name]["budget"] == {"width": 2, "gens": 1, "lam": 2,
                                       "seeds": 1, "nodes": 250, "chunk": 32}
    meta = out["claims_summary"]["_meta"]
    assert meta["budget"] == {"width": 2, "gens": 1, "lam": 2, "seeds": 1}
    assert [g.split("-")[0] for g in meta["grid_fingerprints"]] == [
        "fig14", "shared"]
    assert sorted(meta["grid_fingerprints"]) == sorted(
        os.listdir(tmp_path / "grids"))


def test_cli_default_device_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["--out-dir", str(tmp_path), "--width", "2", "--gens", "1"])
    assert not os.path.exists(tmp_path / "grids")
