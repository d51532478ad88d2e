"""``python -m repro_torch.launch.evolve --device cpu`` prints the same JSON
rows as ``python -m repro.launch.evolve`` on the same grid."""
import json
import os
import subprocess
import sys

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
