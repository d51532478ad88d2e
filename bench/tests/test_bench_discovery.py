"""BENCHMARK.json's shape, and cells found from files by name: every cell
of the repository resolves, and a cell added as files only (the tiny
cells of ``conftest.make_root``) is found and runs on the CPU with
``correct`` true and ``checks`` last in its line."""
import json
import re

import pytest

from bench import harness as H
from conftest import REPO, TINY

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_run_length():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    s = SPEC["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    # a full check of 24 cells fits into 43200 s
    assert (2 + 14 * 24) * (s + 60) + 24 * 180 + 1200 <= 43200


def test_entries_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        for e in SPEC[group]:
            assert set(e) - {"workloads"} == want, e
            assert NAME.match(e["name"])
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.\-]{1,16}$", m["unit"])
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_resolves_and_reports_what_it_must():
    for w in SPEC["workloads"]:
        cell = H.find_cell(w["name"])
        assert w["chips"] == 1
        assert H.driver(cell).run
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
    for c in SPEC["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"].startswith("bench/")


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_cell_added_as_files_runs(tiny_root, name):
    line = H.run(name, 2 ** 31 + 12345, 0.5, False, 0.0, device="cpu",
                 root=tiny_root)
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_traced_run_of_a_cell_added_as_files(tiny_root, name):
    line = H.run(name, 77, 0.5, True, 0.0, device="cpu", root=tiny_root)
    assert line["correct"] is True, line["checks"]
    assert set(line["device"]) >= {"busy_s", "window_s"}
    assert list(line)[-2:] == ["breakdown", "checks"]


def test_an_unknown_cell_is_refused(tiny_root):
    with pytest.raises(KeyError):
        H.find_cell("no.such_cell", tiny_root)
