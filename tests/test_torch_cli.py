"""``python -m repro_torch.launch.evolve --device cpu`` prints the same JSON
rows as ``python -m repro.launch.evolve`` on the same grid."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import evolve as j_evolve
from repro_torch.launch import evolve as t_evolve

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GRIDS = [
    ["--width", "3", "--kind", "mul", "--nodes", "60", "--constraint",
     "mae=1.0", "--constraint", "er=40,acc0", "--generations", "60",
     "--lam", "4", "--seeds", "2"],
    ["--width", "2", "--kind", "add", "--nodes", "30", "--constraint",
     "wce=20", "--constraint", "mre=10", "--generations", "40", "--lam", "8",
     "--seeds", "3", "--chunk-size", "4"],
]


def _rows(out: str) -> list[dict]:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def _summary(out: str) -> str:
    return next(line for line in out.splitlines()
                if line.startswith("[evolve]"))


@pytest.mark.parametrize("args", GRIDS)
def test_cli_rows_match_reference(args, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["repro.launch.evolve", *args])
    j_evolve.main()
    want = capsys.readouterr().out
    t_evolve.main([*args, "--device", "cpu"])
    got = capsys.readouterr().out
    assert _rows(got) == _rows(want)
    n_runs = len(_rows(want))
    assert _summary(got).startswith(f"[evolve] {n_runs}/{n_runs} runs @ ")
    assert _summary(got).endswith(" runs/s")


def test_cli_serial_and_history_none_rows(capsys):
    args = GRIDS[1] + ["--device", "cpu"]
    t_evolve.main(args + ["--history", "none"])
    batched = _rows(capsys.readouterr().out)
    t_evolve.main(args + ["--serial"])
    out = capsys.readouterr().out
    assert "[evolve]" not in out
    assert _rows(out) == batched


def test_cli_help_without_gpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.evolve", "--help"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 0
    for flag in ("--width", "--kind", "--nodes", "--constraint",
                 "--generations", "--lam", "--seeds", "--chunk-size",
                 "--history", "--serial", "--device", "--layout"):
        assert flag in out.stdout


@pytest.mark.parametrize("layout", ["cube_major", "genome_major"])
def test_cli_layout_keeps_the_rows(layout, capsys, monkeypatch):
    args = GRIDS[1] + ["--device", "cpu"]
    t_evolve.main(args)
    default = _rows(capsys.readouterr().out)
    t_evolve.main(args + ["--layout", layout])
    assert _rows(capsys.readouterr().out) == default
    # the reference's CLI takes the same spelling
    monkeypatch.setattr(sys, "argv", ["repro.launch.evolve", *GRIDS[1],
                                      "--layout", layout])
    j_evolve.main()
    assert _rows(capsys.readouterr().out) == default


def test_cli_rejects_an_unknown_layout(capsys):
    with pytest.raises(SystemExit) as exc:
        t_evolve.main(GRIDS[1] + ["--device", "cpu", "--layout", "rows"])
    assert exc.value.code == 2
    assert "--layout" in capsys.readouterr().err


def test_chip_smoke_help_without_gpu():
    out = subprocess.run([sys.executable, "chip_smoke.py", "--help"],
                         capture_output=True, text=True, cwd=REPO,
                         timeout=120)
    assert out.returncode == 0 and "chip_smoke" in out.stdout


# ---------------------------------------------------------------------------
# the sweep engine's execution knobs: --dedup, --dedup-cache-size, --pods,
# --pod-index, --async-commit, --migrate-every, --migrate-timeout
# ---------------------------------------------------------------------------

KNOBS = ["--dedup", "--dedup-cache-size", "--pods", "--pod-index",
         "--async-commit", "--migrate-every", "--migrate-timeout"]
SMALL = ["--width", "2", "--kind", "add", "--nodes", "30", "--constraint",
         "mae=1", "--constraint", "er=50", "--generations", "20", "--lam",
         "3", "--seeds", "2", "--chunk-size", "2"]


def test_cli_help_lists_the_engine_knobs():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.evolve", "--help"],
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 0
    for flag in KNOBS:
        assert flag in out.stdout


GUARDS = {
    "pods-without-results-dir": ["--pods", "2"],
    "serial-pods": ["--serial", "--pods", "2", "--results-dir", "R"],
    "serial-dedup": ["--serial", "--dedup"],
    "serial-async-commit": ["--serial", "--async-commit"],
    "serial-migrate": ["--serial", "--migrate-every", "1", "--results-dir",
                       "R"],
    "migrate-without-results-dir": ["--migrate-every", "1"],
}


@pytest.mark.parametrize("case", sorted(GUARDS))
def test_cli_guards_match_the_reference(case, capsys, monkeypatch):
    args = SMALL + GUARDS[case]
    with pytest.raises(SystemExit) as exc:
        t_evolve.main(args + ["--device", "cpu"])
    assert exc.value.code == 2
    got = capsys.readouterr().err.splitlines()[-1]
    monkeypatch.setattr(sys, "argv", ["repro.launch.evolve", *args])
    with pytest.raises(SystemExit) as exc:
        j_evolve.main()
    assert exc.value.code == 2
    want = capsys.readouterr().err.splitlines()[-1]
    # the same words after the program's name
    assert got.split(": ", 1)[1] == want.split(": ", 1)[1]


def _report(out: str, prefix: str) -> str:
    return next(line for line in out.splitlines() if line.startswith(prefix))


def test_cli_dedup_and_migration_report_lines(tmp_path, capsys, monkeypatch):
    args = SMALL + ["--dedup", "--dedup-cache-size", "64", "--async-commit",
                    "--migrate-every", "1", "--migrate-timeout", "5"]
    monkeypatch.setattr(sys, "argv", ["repro.launch.evolve", *args,
                                      "--results-dir", str(tmp_path / "j")])
    j_evolve.main()
    want = capsys.readouterr().out
    t_evolve.main(args + ["--results-dir", str(tmp_path / "t"), "--device",
                          "cpu"])
    got = capsys.readouterr().out
    for prefix in ("[evolve] dedup cache:", "[evolve] migrate:"):
        assert _report(got, prefix) == _report(want, prefix)
    assert _rows(got) == _rows(want)
    # without the knobs, neither line
    t_evolve.main(SMALL + ["--device", "cpu"])
    plain = capsys.readouterr().out
    assert "dedup cache" not in plain and "migrate:" not in plain


def test_cli_two_pods(tmp_path, capsys):
    args = SMALL + ["--pods", "2", "--results-dir", str(tmp_path),
                    "--device", "cpu", "--history", "summary"]
    t_evolve.main(args + ["--pod-index", "1"])
    out = capsys.readouterr().out
    assert _summary(out).startswith("[evolve] pod 1/2: 2/4 runs @ ")
    t_evolve.main(args + ["--pod-index", "0"])
    out = capsys.readouterr().out
    assert _summary(out).startswith("[evolve] pod 0/2: 4/4 runs @ ")
    assert "2 result shards (4/4 runs" in out
    # outside a process group the pod defaults to 0
    t_evolve.main(args)
    assert _summary(capsys.readouterr().out).startswith(
        "[evolve] pod 0/2: 4/4 runs @ 0.00 runs/s")


def test_cli_knobs_keep_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_evolve.main(SMALL + ["--dedup", "--async-commit", "--pods", "2",
                               "--pod-index", "0", "--migrate-every", "1",
                               "--results-dir", "unused"])


# ---------------------------------------------------------------------------
# the export CLI: the reference's flags, the reference's registry bytes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def export_results(tmp_path_factory):
    """A width-3 multiplier sweep's result shards, two runs a constraint,
    with one run of each constraint marked infeasible (an evolved elite
    never is: the golden parent meets every constraint), and a copy whose
    manifest has no ``problem`` block."""
    import shutil
    from repro_torch.core.evolve import EvolveConfig
    from repro_torch.core.fitness import ConstraintSpec
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.sweep import SweepConfig, run_sweep_batched
    d = str(tmp_path_factory.mktemp("export-shards"))
    run_sweep_batched(
        SearchConfig(width=3, kind="mul", n_n=60,
                     evolve=EvolveConfig(generations=30, lam=4)),
        [ConstraintSpec(mae=2.0), ConstraintSpec(er=40.0)], (0, 1),
        SweepConfig(results_dir=d, keep_history="summary"), device="cpu")
    (shard,) = [n for n in os.listdir(d) if n.startswith("shard_")]
    with np.load(os.path.join(d, shard)) as z:
        data = {k: z[k] for k in z.files}
    data["feasible"] = data["feasible"].copy()
    data["feasible"][::2] = 0
    np.savez(os.path.join(d, shard), **data)
    old = str(tmp_path_factory.mktemp("export-old")) + "/shards"
    shutil.copytree(d, old)
    man_path = os.path.join(old, "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    del man["problem"]
    with open(man_path, "w") as f:
        json.dump(man, f)
    return {"new": d, "old": old}


def _tree_bytes(d) -> dict:
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("which,flags", [
    ("new", []),
    ("new", ["--include-infeasible"]),
    ("new", ["--include-infeasible", "--top-k", "2"]),
    ("old", ["--width", "3", "--kind", "mul"]),
    ("old", ["--width", "3", "--include-infeasible"]),
], ids=["default", "infeasible", "infeasible-top2", "old-width-kind",
        "old-width-infeasible"])
def test_export_cli_writes_the_reference_registry(which, flags,
                                                  export_results, tmp_path,
                                                  capsys):
    from repro.launch import export as j_export
    from repro_torch.launch import export as t_export
    results = export_results[which]
    outs = {}
    for pkg, main in (("jax", j_export.main), ("port", t_export.main)):
        out = str(tmp_path / pkg)
        assert main(["--results-dir", results, "--out", out, *flags]) == 0
        outs[pkg] = (_tree_bytes(out), capsys.readouterr().out)
    (want, want_log), (got, got_log) = outs["jax"], outs["port"]
    assert got == want
    assert got_log.replace(str(tmp_path / "port"), "OUT") == \
        want_log.replace(str(tmp_path / "jax"), "OUT")
    with open(os.path.join(tmp_path / "port", "registry.json")) as f:
        arts = json.load(f)["artifacts"]
    feasible = [bool(a["feasible"]) for a in arts]
    if "--include-infeasible" in flags:
        assert len(arts) == 2 * (2 if "2" in flags else 1)
        assert not all(feasible) or "2" not in flags
    else:
        assert feasible == [True, True]


@pytest.mark.parametrize("flags,match", [
    ([], "pass width="),
    (["--width", "3", "--kind", "add"], "not exportable"),
])
def test_export_cli_refuses_as_the_reference(flags, match, export_results,
                                             tmp_path):
    from repro.launch import export as j_export
    from repro_torch.launch import export as t_export
    for pkg, main in (("jax", j_export.main), ("port", t_export.main)):
        with pytest.raises(ValueError, match=match):
            main(["--results-dir", export_results["old"], "--out",
                  str(tmp_path / pkg), *flags])


def test_export_cli_flags_in_help():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.export",
                          "--help"], capture_output=True, text=True,
                         timeout=60, cwd=REPO, env=env)
    assert out.returncode == 0
    for flag in ("--include-infeasible", "--width", "--kind {mul,add}"):
        assert flag in out.stdout
