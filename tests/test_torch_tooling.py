"""The port's tooling (``launch/dryrun.py``, ``roofline.py``, ``report.py``)
against the reference's, on the CPU.

The reference's ``dryrun`` and ``roofline`` set ``XLA_FLAGS`` to 512 host
devices when imported, which would change the device count of every later
JAX test in the same process, so they run once in a subprocess
(``conftest.run_subprocess``) on an ``Auto`` (2, 4) mesh: under the
installed JAX ``jax.make_mesh`` defaults to explicit axes, where the
reference's train and decode cells raise.  The port's dry run runs in this
process on a fake world (rank 0 of 8 or 4), and a real 4-rank gloo world
(``parallel.spawn.run_ranks``) runs the same steps on real tensors.

Exact throughout: ``model_flops`` and ``active_params`` to the bit; a
rank's argument bytes equal XLA's ``argument_size_in_bytes`` but for two
named terms; the fake world's FLOPs, bytes and collectives equal the real
run's, on (2, 2) and, for phi4-mini's head groups, on (1, 4).
"""
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from conftest import run_subprocess

torch.set_num_threads(1)

ARCHS = ("mamba2_1_3b", "phi4_mini_3_8b", "stablelm_1_6b", "stablelm_12b",
         "llama3_2_1b", "qwen3_moe_30b_a3b", "kimi_k2_1t_a32b",
         "jamba_1_5_large_398b", "llama3_2_vision_11b", "musicgen_large")
SEQ, BATCH = 32, 8                  # the small cells' (seq_len, batch)
# (arch, mode) of the reduced cells held against XLA's argument bytes
ARG_CELLS = (("llama3_2_1b", "train"), ("llama3_2_1b", "prefill"),
             ("llama3_2_1b", "decode"), ("qwen3_moe_30b_a3b", "train"))
MODES = ("train", "prefill", "decode")
HEADS = "phi4_mini_3_8b"            # 6 query heads: head groups at tp = 4
# the CGP cell cut to 4 generations, migrating after the 2nd and 4th
CGP_SMALL = dict(generations=4, migrate_every=2)

REF_SCRIPT = r'''
import json
import repro.launch.dryrun as D          # sets XLA_FLAGS: 512 host devices
import repro.launch.roofline as RL
import jax
from jax.sharding import AxisType
from repro.configs import base as B
from repro.parallel import ctx

out = {{"model_flops": {{}}, "active_params": {{}}, "args": {{}}}}
for arch in B.ARCH_IDS:
    cfg = B.get_arch(arch).CONFIG
    out["active_params"][arch] = RL.active_params(cfg)
    for s in B.shapes_for(arch):
        out["model_flops"][arch + "/" + s.name] = RL.model_flops(cfg, s)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:8])
for arch, mode in {cells!r}:
    mod = B.get_arch(arch)
    mod.CONFIG = mod.reduced()
    with ctx.use_mesh(mesh):
        fn, args, in_sh, out_sh, donate, _ = D.build_cell(
            arch, B.ShapeConfig(mode, {seq}, {batch}, mode))
        compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                           donate_argnums=donate).lower(*args).compile()
    out["args"][arch + "/" + mode] = \
        compiled.memory_analysis().argument_size_in_bytes
print("REF" + json.dumps(out))
'''


@pytest.fixture(scope="module")
def ref():
    text = run_subprocess(REF_SCRIPT.format(cells=ARG_CELLS, seq=SEQ,
                                            batch=BATCH), devices=8)
    line = next(x for x in text.splitlines() if x.startswith("REF"))
    return json.loads(line[3:])


def _shape(mode):
    from repro_torch.configs import base as B
    return B.ShapeConfig(mode, SEQ, BATCH, mode)


def _reduced(arch):
    from repro_torch.configs import base as B
    return B.get_arch(arch).reduced()


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(ref, arch):
    """``active_params`` and every shape cell's ``model_flops`` of the full
    configuration equal the reference's, bit for bit."""
    from repro_torch.configs import base as B
    from repro_torch.launch import roofline as RL
    cfg = B.get_arch(arch).CONFIG
    assert RL.active_params(cfg) == ref["active_params"][arch]
    for s in B.shapes_for(arch):
        assert RL.model_flops(cfg, s) == ref["model_flops"][f"{arch}/{s.name}"]


# ---------------------------------------------------------------------------
# a rank's argument bytes against XLA's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fake_84():
    """The port's dry run of every small cell on a fake world of 8 ranks,
    (data 2, model 4), on fake CPU tensors."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh
    recs = {}
    with D.fake_world(8):
        mesh = make_debug_mesh(2, 4, device="cpu")
        for arch, mode in ARG_CELLS:
            recs[(arch, mode)] = D.trace_cell(
                arch, _shape(mode), mesh, torch.device("cpu"),
                _reduced(arch))
    return recs


def _batch_term(cfg, shape, dp):
    """The bytes of the batch beyond a dp rank's rows: the port's entry
    points take the whole batch on every rank and slice their rows, XLA's
    argument is the device's slice (a decode batch smaller than dp is
    whole on both)."""
    from repro_torch.configs import base as B
    whole = sum(int(np.prod(s)) * torch.empty((), dtype=dt).element_size()
                for s, dt in B.input_specs(cfg, shape).values())
    if shape.mode == "decode" and shape.global_batch < dp:
        return 0
    return whole - whole // dp


@pytest.mark.parametrize("cell", ARG_CELLS, ids=lambda c: "-".join(c))
def test_argument_bytes_match_reference(ref, fake_84, cell):
    """Rank 0's argument bytes on the (2, 4) fake world equal XLA's
    ``argument_size_in_bytes`` of device 0 on the ``Auto`` (2, 4) mesh but
    for two terms: the batch (whole on every rank in the port, a dp slice
    in XLA) and the train step's number (an int32 scalar argument in XLA,
    a Python int in the port: 4 bytes)."""
    arch, mode = cell
    got = fake_84[cell]["memory_analysis"]["argument_size_in_bytes"]
    want = ref["args"][f"{arch}/{mode}"]
    term = _batch_term(_reduced(arch), _shape(mode), 2) \
        - (4 if mode == "train" else 0)
    assert got - want == term, (got, want, term)
    assert term != 0


# ---------------------------------------------------------------------------
# the fake world against a real gloo run
# ---------------------------------------------------------------------------

def _gloo_rank(rank, world):
    """The small llama cells and the small CGP cell on real tensors of a
    (data 2, model 2) gloo world, and phi4-mini's train cell on (data 1,
    model 4) (its 6 heads as 2 head groups), counted (``dryrun.trace``);
    the plain sharded evaluations' shapes recorded (the kernel's on fake
    tensors)."""
    from repro_torch.kernels import ref as kref
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import ctx
    mesh = make_debug_mesh(2, 2, device="cpu")
    out = {}
    cfg = _reduced("llama3_2_1b")
    with ctx.use_mesh(mesh):
        for mode in MODES:
            fn, args, _ = D.build_cell("llama3_2_1b", _shape(mode), "cpu",
                                       cfg)
            out[mode] = D.trace(fn, args)
    with ctx.use_mesh(make_debug_mesh(1, 4, device="cpu")):
        fn, args, _ = D.build_cell(HEADS, _shape("train"), "cpu",
                                   _reduced(HEADS))
        out["heads"] = D.trace(fn, args)
    calls, plain = [], kref.cgp_eval_ref_sharded

    def counted(genome, spec, in_planes, *args):
        calls.append((genome.nodes.shape[0], spec.n_i, spec.n_n, spec.n_o,
                      in_planes.shape[1]))
        return plain(genome, spec, in_planes, *args)

    kref.cgp_eval_ref_sharded = counted
    fn, args, _ = D.build_cgp_cell(mesh, **CGP_SMALL)
    with ctx.use_mesh(mesh):
        out["cgp"] = D.trace(fn, args)
    out["cgp_calls"] = calls
    return out


@pytest.fixture(scope="module", autouse=True)
def _gloo_run(tmp_path_factory):
    """The gloo world's run, started with the module so that it overlaps
    the reference's subprocess and the fake traces."""
    from repro_torch.parallel.spawn import run_ranks
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(run_ranks, _gloo_rank, 4, timeout_s=300.0,
                             workdir=str(tmp_path_factory.mktemp("ranks")))
        yield future
        future.result()


@pytest.fixture(scope="module")
def gloo(_gloo_run):
    return _gloo_run.result()


@pytest.fixture(scope="module")
def fake_22():
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh
    out = {}
    with D.fake_world(4):
        mesh = make_debug_mesh(2, 2, device="cpu")
        for mode in MODES:
            out[mode] = D.trace_cell("llama3_2_1b", _shape(mode), mesh,
                                     torch.device("cpu"),
                                     _reduced("llama3_2_1b"))
        out["cgp"] = D.trace_cgp(mesh, torch.device("cpu"), **CGP_SMALL)
        out["heads"] = D.trace_cell(
            HEADS, _shape("train"), make_debug_mesh(1, 4, device="cpu"),
            torch.device("cpu"), _reduced(HEADS))
    return out


def _counts(rec):
    """The counts a fake world's trace and a real run's must share."""
    return {"cost_analysis": rec["cost_analysis"],
            "collectives": rec["collectives"], "kernels": rec["kernels"],
            "argument_size_in_bytes":
                rec["memory_analysis"]["argument_size_in_bytes"]}


def _differing(got, want, path=""):
    """The paths of the keys where two nested dicts differ, with both
    values."""
    if isinstance(got, dict) and isinstance(want, dict):
        return [d for k in dict.fromkeys([*got, *want])
                for d in _differing(got.get(k), want.get(k),
                                    f"{path}/{k}")]
    return [] if got == want else [(path, got, want)]


@pytest.mark.parametrize("mode", MODES)
def test_fake_world_matches_gloo_run(gloo, fake_22, mode):
    """The reduced llama's step on rank 0 of a fake (2, 2) world counts
    what rank 0 of a real 4-rank gloo run counts: FLOPs by dtype, the
    aten ops' bytes, and every collective's calls and output bytes by op,
    by link and by group size."""
    got, want = fake_22[mode], gloo[0][mode]
    assert _differing(_counts(got), _counts(want)) == []
    assert got["collectives"]["total_bytes"] > 0
    assert got["kernels"] == []


def test_fake_world_matches_gloo_run_on_head_groups(gloo, fake_22):
    """phi4-mini's train step on rank 0 of a fake (1, 4) world, its 6
    query heads as 2 head groups × 2 head_dim halves, counts what rank 0
    of the real gloo run counts, the collectives over the 2-rank groups
    (the q / k / v and output gathers, the scores' all-reduces, and
    their backward's reduce-scatters and all-reduces) among them, by op,
    bytes, link and group size."""
    got, want = fake_22["heads"], gloo[0]["heads"]
    assert _differing(_counts(got), _counts(want)) == []
    pairs = got["collectives"]["per_group"]["2"]
    assert pairs > 0 and set(got["collectives"]["per_link"]) == {"nvlink"}
    assert got["collectives"]["calls"]["reduce-scatter"] > 0


def test_cgp_cell_matches_gloo_run(gloo, fake_22):
    """The CGP cell (4 generations, migrating twice) on a fake (2, 2)
    world, calibrated from three short traces, against a real 4-rank gloo
    run of all 4 generations: the same evaluations (one R = 1 for the
    island's first parent, then one R = λ = 8 a generation, each on the
    rank's 1024-word half of the cube), the same migration and output
    all-gathers, and as many all-reduces.  Their bytes differ by design:
    on the card the evaluation all-reduces the kernel's raw sums, on the
    CPU the decoded partials (``ref.cgp_eval_ref_sharded``)."""
    got, want = fake_22["cgp"], gloo[0]["cgp"]
    calls = {}
    for c in gloo[0]["cgp_calls"]:
        calls[c] = calls.get(c, 0) + 1
    assert {tuple(k["shape"]): k["calls"] for k in got["kernels"]} == calls
    assert calls == {(1, 16, 400, 16, 1024): 1, (8, 16, 400, 16, 1024): 4}
    for key in ("per_op", "calls"):
        assert got["collectives"][key]["all-gather"] == \
            want["collectives"][key]["all-gather"]
    assert got["collectives"]["calls"]["all-reduce"] == \
        want["collectives"]["calls"]["all-reduce"] == 4 * 5
    assert got["cost_analysis"]["flops"] == want["cost_analysis"]["flops"]
    for r in gloo:
        assert r["cgp_calls"] == gloo[0]["cgp_calls"]


# ---------------------------------------------------------------------------
# calibration, the abstract route, the work models
# ---------------------------------------------------------------------------

def test_period_calibration_is_exact():
    """The roofline's two-point calibration: the counts of a 4-layer model
    from its 1- and 2-layer traces (``analyze_cell``) equal the 4-layer
    trace's, and its terms are those counts over the H100's peaks."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import make_debug_mesh
    cfg = dataclasses.replace(_reduced("llama3_2_1b"), n_layers=4)
    with D.fake_world(4):
        mesh = make_debug_mesh(2, 2, device="cpu")
        row = RL.analyze_cell("llama3_2_1b", _shape("train"), "cpu", cfg,
                              mesh)
        whole = D.trace_cell("llama3_2_1b", _shape("train"), mesh,
                             torch.device("cpu"), cfg)
    total = row["counts"]
    for key in ("cost_analysis", "collectives"):
        assert total[key] == whole[key]
    assert total["memory_analysis"]["argument_size_in_bytes"] == \
        whole["memory_analysis"]["argument_size_in_bytes"]
    assert row["chips"] == 4 and row["kernel_s"] == 0
    assert row["compute_s"] == whole["cost_analysis"]["flops"] / 67e12
    assert row["collective_s"] == whole["collectives"]["total_bytes"] / 450e9
    assert row["dominant"] == max(("compute", "memory", "collective"),
                                  key=lambda k: row[k + "_s"])


# a served cell's peak at full depth against its 1- and 2-period traces:
# the terms are integer byte counts of the same allocations, so the
# extrapolation should hit the full-depth dry run; 1% allows for an
# allocation order that moves the peak by a few tensors
SERVED_PEAK_RTOL = 0.01


@pytest.mark.parametrize("arch,mode", [("llama3_2_1b", m) for m in MODES]
                         + [("musicgen_large", "prefill")])
def test_extrapolated_peak_against_a_full_depth_dry_run(arch, mode):
    """``analyze_cell``'s peak a rank at 4 periods on a fake (1, 4) world
    within SERVED_PEAK_RTOL of a dry run of the same cell at 4 periods:
    the reduced llama (its 2 kv heads under tp = 4: the cache at rest
    splits head_dim, so the first layer's temporaries differ from the
    others'; the linear extrapolation read 12.6% high in decode) and
    musicgen's prefill, whose peak comes before its caches pile up.  A
    training step's peak grows a period at a time, a prefill's and a
    decode step's only by their arguments and, where its peak comes last,
    a prefill's caches."""
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as RL
    from repro_torch.launch.mesh import make_debug_mesh
    cfg = _reduced(arch)
    cfg = dataclasses.replace(cfg, n_layers=4 * len(cfg.period))
    shape = _shape(mode)
    with D.fake_world(4):
        mesh = make_debug_mesh(1, 4, device="cpu")
        row = RL.analyze_cell(arch, shape, "cpu", cfg, mesh)
        whole = D.trace_cell(arch, shape, mesh, torch.device("cpu"), cfg)
    want = whole["memory_analysis"]
    got = row["counts"]["memory_analysis"]
    assert got["argument_size_in_bytes"] == want["argument_size_in_bytes"]
    assert row["peak_bytes_per_chip"] == got["peak_bytes"]
    np.testing.assert_allclose(got["peak_bytes"], want["peak_bytes"],
                               rtol=SERVED_PEAK_RTOL)


def test_sequence_split_decode_traces():
    """long_500k's path, a decode batch smaller than dp (the reduced jamba,
    batch 1 on a fake (2, 2) world): the sequence-split decode traces (its
    owner write has no data-dependent shape) and merges its partial
    softmaxes over the dp ranks (a MAX and two SUM all-reduces, beside
    the expert-parallel layers' own)."""
    from repro_torch.configs import base as B
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_debug_mesh
    cfg = _reduced("jamba_1_5_large_398b")
    with D.fake_world(4):
        mesh = make_debug_mesh(2, 2, device="cpu")
        rec = D.trace_cell("jamba_1_5_large_398b",
                           B.ShapeConfig("long", 64, 1, "decode"), mesh,
                           torch.device("cpu"), cfg)
    assert rec["collectives"]["calls"]["all-reduce"] >= 3
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0


def _no_build(monkeypatch):
    """Make building or loading any kernel library fail the test."""
    from repro_torch.kernels import cgp_sim, flash_attention, lut_matmul
    for mod in (cgp_sim, flash_attention, lut_matmul):
        monkeypatch.setattr(mod, "_library", lambda: pytest.fail("built"))
        monkeypatch.setattr(mod, "build", lambda: pytest.fail("built"))


@pytest.mark.parametrize("mode", ["meta", "fake"])
def test_abstract_route_builds_and_launches_nothing(monkeypatch, mode):
    """Fake and meta tensors take the abstract route of all three entry
    points: results of the kernels' shapes and dtypes, each call recorded
    with its work model's arguments, nothing built, loaded or launched,
    and no data-dependent check run (an int64 operand, whose range a CUDA
    tensor would have checked)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.core.genome import Genome
    from repro_torch.core.search import SearchConfig, problem_arrays
    from repro_torch.kernels import ops
    _no_build(monkeypatch)
    monkeypatch.setattr(ops, "TRACED", [])
    gold, spec, planes, gvals, _ = problem_arrays(
        SearchConfig(width=4, kind="mul", n_n=80), "cpu")
    ctx = FakeTensorMode(allow_non_fake_inputs=True) if mode == "fake" \
        else torch.device("meta")
    with ctx:
        a = torch.empty((6, 40), dtype=torch.int64)
        b = torch.empty((40, 24), dtype=torch.uint8)
        c = ops.lut_matmul(a, b, torch.empty((256, 256), dtype=torch.int32))
        q = torch.empty((2, 8, 128, 16), dtype=torch.bfloat16)
        kv = torch.empty((2, 2, 128, 16), dtype=torch.bfloat16)
        o = ops.flash_attention(q, kv, kv)
        g = Genome(torch.empty((3,) + tuple(gold.nodes.shape),
                               dtype=torch.int32),
                   torch.empty((3,) + tuple(gold.outs.shape),
                               dtype=torch.int32))
        partials, pops = ops.cgp_eval_batched(
            g, spec, torch.empty(tuple(planes.shape), dtype=torch.int32),
            torch.empty(tuple(gvals.shape), dtype=torch.int32))
    assert (tuple(c.shape), c.dtype) == ((6, 24), torch.int32)
    assert (tuple(o.shape), o.dtype) == ((2, 8, 128, 16), torch.bfloat16)
    assert tuple(pops.shape) == (3, spec.n_n)
    assert tuple(partials.hist.shape) == (3, 10)
    assert ops.TRACED == [
        {"kernel": "lut_matmul", "shape": [6, 40, 24], "dtype": "uint8"},
        {"kernel": "flash_attention", "shape": [2, 8, 2, 128, 128, 16, 2, 1],
         "dtype": "bfloat16"},
        {"kernel": "cgp_sim", "shape": [3, 8, 80, 8, planes.shape[1]],
         "dtype": "int32"}]


def test_moved_bounds_give_perf_md_bounds():
    """The work models moved out of ``chip_smoke.py`` give PERF.md's
    bounds at its shapes: row 1 (R = 256, width 8, 400 nodes, W = 2048),
    row 5 ((128, 2048, 8192)), row 6 (bf16 causal (1, 32, 8, 32768, 64)
    and (1, 32, 8, 4096, 112 / 160)); flash takes Hkv from the shape."""
    from repro_torch.launch import roofline as RL
    assert round(RL.bound_ms(256, 16, 400, 16, 2048)[0], 4) == 0.0751
    assert round(RL.lut_bound_ms(128, 2048, 8192)[0], 4) == 0.1282
    f = lambda S, D, hkv=8: RL.flash_bound_ms(1, 32, hkv, S, S, D, 2)[0]
    assert round(f(32768, 64), 4) == 4.4471
    assert (round(f(4096, 112), 4), round(f(4096, 160), 4)) == \
        (0.1216, 0.1738)
    # the bytes term reads each kv-head once: kimi-k2's 64 / 8, a decode
    # step (bytes-bound) of 8 kv-heads against 32
    kimi = RL.flash_bound_ms(1, 64, 8, 1, 4096, 112, 2, causal=False)
    mha = RL.flash_bound_ms(1, 64, 64, 1, 4096, 112, 2, causal=False)
    assert kimi[1] == mha[1] == "bytes" and mha[0] > 7 * kimi[0]
    assert RL.attention_pairs(4, 4) == 10 and RL.attention_pairs(4, 6) == 10
    assert RL.attention_pairs(6, 4) == 18
    assert RL.link(range(8, 16)) == "nvlink" and RL.link([7, 8]) == "nic"


# ---------------------------------------------------------------------------
# reports and CLIs
# ---------------------------------------------------------------------------

REF_RECORD = {
    "arch": "llama3_2_1b", "shape": "train_4k", "mesh": "single",
    "n_devices": 256, "ok": True, "lower_s": 1.5, "compile_s": 12.25,
    "memory_analysis": {"argument_size_in_bytes": 211243012,
                        "temp_size_in_bytes": 7.1e10},
    "cost_analysis": {"flops": 7.0e14, "bytes accessed": 2.1e13},
    "collectives": {"total_bytes": 5.9e9,
                    "per_op": {"all-gather": 4.6e9, "all-reduce": 1.3e9}},
    "n_periods": 16}
ROOFLINE_ROW = {
    "arch": "llama3_2_1b", "shape": "train_4k", "chips": 256,
    "compute_s": 1.93, "memory_s": 6.25, "collective_s": 0.12,
    "dominant": "memory", "model_flops_total": 7.77e15,
    "useful_flops_ratio": 0.0433, "roofline_fraction": 0.0049}


def test_reports_match_reference(fake_84, tmp_path):
    """Both packages' reports give the same tables on the same records,
    reference-format and the port's own, but for the dry run's fifth
    column (the reference's "compile s", the port's "trace s") and the
    FLOPs column's name."""
    from repro.launch import report as ref_report
    from repro_torch.launch import report
    from repro_torch.launch import roofline as RL
    d = tmp_path / "dryrun"
    d.mkdir()
    port = dict(fake_84[("llama3_2_1b", "train")], arch="llama3_2_1b",
                shape="small", mesh="2x4", n_devices=8, ok=True)
    for name, rec in (("a", REF_RECORD), ("b", port),
                      ("c", {**REF_RECORD, "ok": False, "arch": "x"})):
        (d / f"{name}.json").write_text(json.dumps(rec))
    got = report.dryrun_table(str(d)).splitlines()
    want = ref_report.dryrun_table(str(d)).splitlines()
    assert len(got) == len(want) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.split("|"), w.split("|")
        assert len(g) == len(w) == 13
        keep = [j for j in range(len(g))
                if j != 6 and not (i == 0 and j == 9)]
        assert [g[j] for j in keep] == [w[j] for j in keep], (g, w)
    assert got[2].split("|")[6].strip() == ""
    assert got[3].split("|")[6].strip() == str(port["trace_s"])
    for cols in (list(ROOFLINE_ROW) + ["hlo_flops_per_chip"], RL.COLUMNS):
        path = tmp_path / "roofline.csv"
        rows = [ROOFLINE_ROW, {"arch": "y", "shape": "z"}]
        path.write_text(",".join(cols) + "\n" + "".join(
            ",".join(str(r.get(c, "")) for c in cols) + "\n" for r in rows))
        assert report.roofline_table(str(path)) == \
            ref_report.roofline_table(str(path))


@pytest.mark.parametrize("cli", ["dryrun", "roofline", "report"])
def test_cli_help(cli, capsys):
    """Every tool is a CLI with the reference's flags (and ``--device``
    where it touches a device)."""
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{cli}")
    with pytest.raises(SystemExit) as e:
        mod.main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    flags = {"dryrun": ("--arch", "--shape", "--mesh", "--all", "--cgp",
                        "--out", "--device"),
             "roofline": ("--arch", "--shape", "--all", "--out",
                          "--device"),
             "report": ()}[cli]
    for flag in flags:
        assert flag in text


@pytest.mark.parametrize("argv", [
    ("dryrun", ["--cgp"]), ("dryrun", ["--arch", "llama3_2_1b", "--shape",
                                      "train_4k"]),
    ("roofline", ["--arch", "llama3_2_1b", "--shape", "train_4k"])],
    ids=["dryrun-cgp", "dryrun-cell", "roofline-cell"])
def test_cli_device_defaults_to_cuda(argv, tmp_path):
    """``--device`` defaults to ``cuda``, which raises without a card
    before anything is traced or written."""
    import importlib
    mod = importlib.import_module(f"repro_torch.launch.{argv[0]}")
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv[1] + ["--out", str(out)])
    assert not out.exists()


def test_dryrun_cli_on_cpu(tmp_path, capsys, monkeypatch):
    """The dry-run CLI with ``--device cpu`` on a production cell of the
    single-pod mesh (llama3.2-1b's ``CONFIG`` swapped for ``reduced()`` to
    keep it short): a brief JSON line, and a record under ``--out`` whose
    collectives all cross nodes."""
    from repro_torch.configs import base as B
    from repro_torch.launch import dryrun as D
    mod = B.get_arch("llama3_2_1b")
    monkeypatch.setattr(mod, "CONFIG", mod.reduced())
    D.main(["--arch", "llama3_2_1b", "--shape", "decode_32k", "--device",
            "cpu", "--out", str(tmp_path)])
    brief = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert brief["ok"] is True, brief
    rec = json.loads((tmp_path / "llama3_2_1b__decode_32k__single.json"
                      ).read_text())
    assert rec["n_devices"] == 256 and rec["n_periods"] == 2
    assert rec["collectives"]["per_link"]["nic"] > 0
