"""Product tables and the artifact registry of the port against the JAX
package: ``multiplier_lut`` and ``content_digest`` bit for bit, registries
interchangeable (each package's ``verify_registry`` passes the other's),
the same elites selected, and the same refusals of damaged artifacts."""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.core import artifacts as JA
from repro.core import golden as JG
from repro.core.evolve import EvolveConfig as JEvolveConfig
from repro.core.fitness import ConstraintSpec as JConstraint
from repro.core.genome import random_genome
from repro.core.library import multiplier_lut as j_multiplier_lut
from repro.core.search import SearchConfig as JSearchConfig
from repro.core.sweep import SweepConfig as JSweepConfig
from repro.core.sweep import run_sweep_batched as j_run_sweep_batched
from repro_torch import convert
from repro_torch.core import artifacts as A
from repro_torch.core import golden
from repro_torch.core.evolve import EvolveConfig
from repro_torch.core.fitness import ConstraintSpec
from repro_torch.core.genome import CGPSpec
from repro_torch.core.library import multiplier_lut
from repro_torch.core.search import SearchConfig
from repro_torch.core.sweep import SweepConfig, run_sweep_batched
from repro_torch.launch import export as t_export

# the test workers share the machine's cores: one intra-op thread each
torch.set_num_threads(1)

CONSTRAINTS = [dict(mae=2.0), dict(er=60.0), dict(wce=30.0)]
SEEDS = (0, 1)
WIDTH, NODES, GENS = 3, 60, 40


@pytest.mark.parametrize("width", [1, 2, 3, 4, 8])
def test_multiplier_lut_matches_jax(width):
    jgold, jspec = JG.array_multiplier(width)
    gold, spec = golden.array_multiplier(width)
    want = j_multiplier_lut(jgold, jspec)
    got = multiplier_lut(gold, spec)
    assert got.dtype == np.int32 and got.shape == (1 << width, 1 << width)
    assert np.array_equal(got, want)
    a = np.arange(1 << width)
    assert np.array_equal(got, a[:, None] * a[None, :])
    keys = jax.random.split(jax.random.PRNGKey(width), 3)
    for k in keys:
        jg = random_genome(k, jspec)
        assert np.array_equal(multiplier_lut(convert.genome(jg), spec),
                              j_multiplier_lut(jg, jspec))


def _payload(rng):
    return {"lut": rng.integers(0, 1 << 16, (16, 16)).astype(np.int32),
            "kind": np.str_("mul"), "constraint": np.str_("mae<=2%+acc0"),
            "width": np.int32(4), "power_rel": np.float32(0.61),
            "feasible": np.uint8(1), "metrics": rng.random(7, np.float32),
            "grid_fingerprint": np.str_("ab" * 32)}


def test_content_digest_matches_jax():
    rng = np.random.default_rng(0)
    payload = _payload(rng)
    assert A.content_digest(payload) == JA.content_digest(payload)
    payload["digest"] = np.str_("x")           # excluded from the digest
    assert A.content_digest(payload) == JA.content_digest(payload)
    flipped = dict(payload, lut=payload["lut"] ^ np.int32(1) * (
        np.arange(256).reshape(16, 16) == 7))
    assert A.content_digest(flipped) != A.content_digest(payload)
    assert A.content_digest(flipped) == JA.content_digest(flipped)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """Results directories of the same width-3 grid, one per package."""
    dirs = {}
    dirs["jax"] = str(tmp_path_factory.mktemp("jax-shards"))
    j_run_sweep_batched(
        JSearchConfig(width=WIDTH, kind="mul", n_n=NODES,
                      evolve=JEvolveConfig(generations=GENS, lam=4)),
        [JConstraint(**c) for c in CONSTRAINTS], SEEDS,
        JSweepConfig(chunk_size=4, keep_history="none",
                     results_dir=dirs["jax"]))
    dirs["port"] = str(tmp_path_factory.mktemp("port-shards"))
    run_sweep_batched(
        SearchConfig(width=WIDTH, kind="mul", n_n=NODES,
                     evolve=EvolveConfig(generations=GENS, lam=4)),
        [ConstraintSpec(**c) for c in CONSTRAINTS], SEEDS,
        SweepConfig(chunk_size=4, keep_history="none",
                    results_dir=dirs["port"]), device="cpu")
    return dirs


def _registry(export, results_dir, out, **kw):
    export(results_dir, out, **kw)
    with open(os.path.join(out, A.REGISTRY)) as f:
        reg = json.load(f)
    reg.pop("source_results_dir")
    return reg


@pytest.mark.parametrize("source", ["jax", "port"])
def test_registries_interchange(sweeps, source, tmp_path):
    """Both packages export the same elites from one results directory into
    byte-identical artifacts, and each verifies the other's registry."""
    jreg = _registry(JA.export_elites, sweeps[source], str(tmp_path / "j"))
    treg = _registry(A.export_elites, sweeps[source], str(tmp_path / "t"))
    assert treg == jreg
    assert len(treg["artifacts"]) == len(CONSTRAINTS)
    for e in treg["artifacts"]:
        with open(tmp_path / "j" / e["file"], "rb") as fj, \
                open(tmp_path / "t" / e["file"], "rb") as ft:
            assert fj.read() == ft.read()
    arts = A.verify_registry(str(tmp_path / "j"))
    jarts = JA.verify_registry(str(tmp_path / "t"))
    assert [a.digest for a in arts] == [a.digest for a in jarts]
    for art in arts:
        assert art.lut.shape == (8, 8) and art.certified and art.feasible
    best = A.select_artifact(str(tmp_path / "t"))
    assert os.path.basename(best) == os.path.basename(
        JA.select_artifact(str(tmp_path / "j")))
    assert A.resolve_artifact(str(tmp_path / "t")).path == best


def test_both_sweeps_export_the_same_registry(sweeps, tmp_path):
    a = _registry(A.export_elites, sweeps["jax"], str(tmp_path / "a"))
    b = _registry(A.export_elites, sweeps["port"], str(tmp_path / "b"))
    for ea, eb in zip(a["artifacts"], b["artifacts"]):
        assert (ea["grid_row"], ea["constraint"], ea["seed"]) == (
            eb["grid_row"], eb["constraint"], eb["seed"])
        np.testing.assert_allclose(ea["power_rel"], eb["power_rel"],
                                   rtol=1e-6)
    assert a["grid_fingerprint"] == b["grid_fingerprint"]


def test_policy_and_idempotence(sweeps, tmp_path):
    out = str(tmp_path / "reg")
    first = _registry(A.export_elites, sweeps["port"], out,
                      policy=A.ExportPolicy(top_k=2, feasible_only=False))
    assert len(first["artifacts"]) == 2 * len(CONSTRAINTS)
    assert _registry(A.export_elites, sweeps["port"], out,
                     policy=A.ExportPolicy(top_k=2,
                                           feasible_only=False)) == first
    assert len([f for f in os.listdir(out) if f.endswith(".npz")]) == 6
    with pytest.raises(ValueError, match="not exportable"):
        A.export_elites(sweeps["port"], str(tmp_path / "x"), kind="add")
    with pytest.raises(ValueError, match="contradicts"):
        A.export_elites(sweeps["port"], str(tmp_path / "x"), width=4)


def _tamper_flip_lut(p):
    p["lut"] = p["lut"].copy()
    p["lut"][0, 1] ^= 1


def _tamper_restamp_digest(p):
    p["digest"] = np.str_("0" * 64)


def _tamper_lut_with_new_digest(p):
    p["lut"] = p["lut"].copy()
    p["lut"][2, 3] += 1
    p["digest"] = np.str_(A.content_digest(p))


def _tamper_genome_with_new_digest(p):
    p["genome_outs"] = p["genome_outs"][::-1].copy()
    p["digest"] = np.str_(A.content_digest(p))


@pytest.mark.parametrize("tamper,match", [
    (_tamper_flip_lut, "digest mismatch"),
    (_tamper_restamp_digest, "digest mismatch"),
    (_tamper_lut_with_new_digest, "genome replay"),
    (_tamper_genome_with_new_digest, "genome replay")])
def test_damaged_artifacts_refused_by_both(sweeps, tmp_path, tamper, match):
    out = str(tmp_path / "reg")
    reg = A.export_elites(sweeps["port"], out)
    path = os.path.join(out, reg["artifacts"][0]["file"])
    with np.load(path) as z:
        payload = {k: np.asarray(z[k]) for k in z.files}
    tamper(payload)
    np.savez(path, **payload)
    for load in (A.load_artifact, JA.load_artifact):
        with pytest.raises(ValueError, match=match):
            load(path)
    for verify in (A.verify_registry, JA.verify_registry):
        with pytest.raises(ValueError):
            verify(out)
    assert A.load_artifact(path, verify=False).digest == str(
        payload["digest"])


def test_wrong_fingerprint_and_foreign_registry_refused(sweeps, tmp_path):
    out = str(tmp_path / "reg")
    reg = A.export_elites(sweeps["port"], out)
    path = os.path.join(out, reg["artifacts"][0]["file"])
    with pytest.raises(ValueError, match="wrong sweep"):
        A.load_artifact(path, expect_fingerprint="0" * 64)
    reg["grid_fingerprint"] = "f" * 64
    with open(os.path.join(out, A.REGISTRY), "w") as f:
        json.dump(reg, f)
    with pytest.raises(ValueError, match="different sweep"):
        A.export_elites(sweeps["port"], out)
    with pytest.raises(ValueError, match="wrong sweep"):
        A.verify_registry(out)


def test_pre_problem_manifest_needs_width(sweeps, tmp_path):
    d = str(tmp_path / "old")
    shutil.copytree(sweeps["port"], d)
    man_path = os.path.join(d, "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    man["problem"] = None
    with open(man_path, "w") as f:
        json.dump(man, f)
    with pytest.raises(ValueError, match="predates problem metadata"):
        A.export_elites(d, str(tmp_path / "r1"))
    assert A.export_elites(d, str(tmp_path / "r2"),
                           width=WIDTH)["problem"]["width"] == WIDTH


def test_export_cli(sweeps, tmp_path, capsys):
    out = str(tmp_path / "cli")
    assert t_export.main(["--results-dir", sweeps["port"], "--out", out,
                          "--top-k", "1"]) == 0
    assert f"{len(CONSTRAINTS)} artifact(s) -> {out}" in capsys.readouterr().out
    assert t_export.main(["--verify", out]) == 0
    assert f"{len(CONSTRAINTS)} artifact(s) verified" in \
        capsys.readouterr().out
    assert len(JA.verify_registry(out)) == len(CONSTRAINTS)


def test_replay_rebuilds_the_problem_from_the_artifact():
    """The replay spec comes from (width, n_n, len(outs)) alone."""
    gold, spec = golden.array_multiplier(2)
    assert CGPSpec(2 * 2, spec.n_o, spec.n_n) == spec
    lut = A._recompute_lut(gold.nodes.numpy(), gold.outs.numpy(), 2,
                           spec.n_n, spec.n_o)
    assert np.array_equal(lut, JA._recompute_lut(
        gold.nodes.numpy(), gold.outs.numpy(), 2, spec.n_n, spec.n_o))
    assert np.array_equal(lut, np.arange(4)[:, None] * np.arange(4))
