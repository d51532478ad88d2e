"""Boundaries of the port: it never imports JAX or the JAX package, and it
never falls back from the card to the CPU."""
import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
EXAMPLES = sorted(os.path.join(REPO, "examples", f)
                  for f in os.listdir(os.path.join(REPO, "examples"))
                  if f.endswith("_torch.py"))
PORT_FILES = sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs
     if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]
    + EXAMPLES)
CUDA_FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(PORT)
                    for f in fs if f.endswith((".cu", ".cuh")))


def _imported_modules(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def test_port_files_found():
    names = {os.path.relpath(p, PORT) for p in PORT_FILES}
    for mod in ("random.py", "convert.py", "core/evolve.py", "core/sweep.py",
                "kernels/cgp_sim.py", "kernels/ops.py", "launch/evolve.py",
                "core/results.py", "core/artifacts.py", "core/library.py",
                "checkpoint/store.py", "kernels/lut_matmul.py",
                "kernels/nvcc.py", "models/quant.py", "models/model.py",
                "configs/llama3_2_1b.py", "launch/serve.py",
                "launch/export.py", "kernels/tune.py",
                "kernels/flash_attention.py", "kernels/ref.py",
                "parallel/ctx.py", "parallel/spawn.py", "launch/mesh.py",
                "core/pareto.py", "core/sampling.py", "core/certify.py",
                "data/pipeline.py", "core/evalcache.py", "core/commit.py",
                "core/migrate.py", "tree.py", "optim/__init__.py",
                "optim/optimizer.py", "optim/schedule.py",
                "optim/compress.py", "runtime/fault.py", "launch/steps.py",
                "launch/train.py", "configs/phi4_mini_3_8b.py",
                "configs/stablelm_1_6b.py", "configs/stablelm_12b.py",
                "launch/figures.py"):
        assert mod in names
    assert [os.path.basename(p) for p in EXAMPLES] == [
        "approx_nn_inference_torch.py", "pareto_sweep_torch.py",
        "quickstart_torch.py", "train_lm_torch.py"]
    sources = {os.path.relpath(p, PORT) for p in CUDA_FILES}
    assert sources == {"kernels/csrc/cgp_sim.cu", "kernels/csrc/lut_matmul.cu",
                       "kernels/csrc/flash_attention.cu"}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), (
            f"{path} imports {mod}")


def test_import_leaves_jax_unloaded():
    mods = ["repro_torch." + os.path.relpath(p, PORT)[:-3].replace(os.sep, ".")
            for p in PORT_FILES if p.startswith(PORT)]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 0, out.stderr


def test_default_device_raises_without_a_card(monkeypatch):
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.sweep import run_sweep_batched
    from repro_torch.core.fitness import ConstraintSpec
    from repro_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep_batched(SearchConfig(width=2, kind="add", n_n=20),
                          [ConstraintSpec(mae=1.0)], (0,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def _no_plain_path(monkeypatch):
    from repro_torch.kernels import ref
    for name in ("cgp_eval_ref", "cgp_eval_ref_sharded"):
        monkeypatch.setattr(ref, name, lambda *a, **k: pytest.fail(
            "the plain path ran"))


def test_non_cpu_tensors_never_take_the_plain_path(monkeypatch):
    """A tensor off the CPU launches the kernel or raises (a ``meta``
    tensor stands in for a card's, with the abstract route off); a tensor
    that holds no data, ``meta`` or fake, takes the abstract route
    (``launch/dryrun.py``): the plain path runs in neither case."""
    from repro_torch.core.search import SearchConfig, problem_arrays
    from repro_torch.kernels import ops
    _no_plain_path(monkeypatch)
    gold, spec, planes, gvals, _ = problem_arrays(
        SearchConfig(width=2, kind="mul", n_n=20), "cpu")
    g = type(gold)(gold.nodes[None].to("meta"), gold.outs[None].to("meta"))
    with monkeypatch.context() as m:
        m.setattr(ops, "abstract", lambda t: False)
        with pytest.raises(ValueError, match="no cgp_sim kernel"):
            ops.cgp_eval_batched(g, spec, planes.to("meta"),
                                 gvals.to("meta"))
    monkeypatch.setattr(ops, "TRACED", [])
    _, pops = ops.cgp_eval_batched(g, spec, planes.to("meta"),
                                   gvals.to("meta"))
    assert pops.device.type == "meta"
    assert [c["kernel"] for c in ops.TRACED] == ["cgp_sim"]


def test_sharded_evaluation_never_takes_the_plain_path_off_the_cpu(
        monkeypatch):
    """A process group changes where the cube lies, not which path a
    tensor takes: off the CPU the sharded kernel launches or raises, before
    any collective (a ``meta`` tensor stands in for a card's, with the
    abstract route off)."""
    from repro_torch.core.search import SearchConfig, problem_arrays
    from repro_torch.kernels import cgp_sim, ops
    _no_plain_path(monkeypatch)
    monkeypatch.setattr(ops, "abstract", lambda t: False)
    gold, spec, planes, gvals, _ = problem_arrays(
        SearchConfig(width=2, kind="mul", n_n=20), "cpu")
    g = type(gold)(gold.nodes[None].to("meta"), gold.outs[None].to("meta"))
    with pytest.raises(ValueError, match="no cgp_sim kernel"):
        ops.cgp_eval_batched(g, spec, planes.to("meta"), gvals.to("meta"),
                             group=object())
    assert cgp_sim.SHARDED_LAUNCHES == 0


def test_mesh_default_device_raises_without_a_card(monkeypatch):
    from repro_torch.parallel import ctx
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctx.default_device(0)


def test_serve_default_device_raises_without_a_card(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: serve.serve("llama3_2_1b"),
                 lambda: serve.quality_report("llama3_2_1b", None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3_2_1b", "--reduced"])


def test_train_default_device_raises_without_a_card(monkeypatch):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.train("llama3_2_1b", steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "llama3_2_1b", "--reduced", "--steps", "1"])


def test_pallas_attention_raises_under_training():
    """Neither package can differentiate the flash kernel: training on
    ``attn_impl="pallas"`` raises, in the train step and at the
    attention call, on any device."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.configs import llama3_2_1b
    from repro_torch.launch import steps
    from repro_torch.models import attention, model
    from repro_torch.optim import OptConfig, init_opt_state
    cfg = dataclasses.replace(llama3_2_1b.reduced(), attn_impl="pallas")
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    state = init_opt_state(convert.reference_tree(params, cfg), OptConfig())
    toks = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="no backward"):
        steps.make_train_step(cfg, OptConfig())(
            params, state, {"tokens": toks, "targets": toks}, 0)
    q = torch.zeros((1, 8, 4, 8), requires_grad=True)
    k = torch.zeros((1, 8, 2, 8))
    with pytest.raises(NotImplementedError, match="no backward"):
        attention.run_attention(q, k, k, cfg)
    with torch.no_grad():
        assert attention.run_attention(q, k, k, cfg).shape == q.shape


def test_lut_matmul_never_takes_the_plain_path_off_the_cpu():
    from repro_torch.kernels import lut_matmul
    a = torch.zeros((4, 8), dtype=torch.uint8, device="meta")
    b = torch.zeros((8, 3), dtype=torch.uint8, device="meta")
    table = torch.zeros((65536,), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="no lut_matmul kernel"):
        lut_matmul.lut_matmul(a, b, table)


def test_pallas_attention_raises(monkeypatch):
    """``attn_impl="pallas"`` runs the flash kernel: off the CPU it
    launches it or raises (never the plain version; a ``meta`` tensor
    stands in for a card's, with the abstract route off), and on any device
    it raises where the reference asserts."""
    import dataclasses
    from repro_torch.configs import llama3_2_1b
    from repro_torch.kernels import ops, ref
    from repro_torch.models import attention
    cfg = dataclasses.replace(llama3_2_1b.reduced(), attn_impl="pallas")
    q = torch.zeros((1, 8, 4, 8), device="meta")
    k = torch.zeros((1, 8, 2, 8), device="meta")
    with monkeypatch.context() as m:
        m.setattr(ops, "abstract", lambda t: False)
        m.setattr(ref, "flash_attention_ref",
                  lambda *a: pytest.fail("the plain path ran"))
        with pytest.raises(ValueError, match="no flash_attention kernel"):
            attention.run_attention(q, k, k, cfg)
    q, k = torch.zeros((1, 130, 4, 8)), torch.zeros((1, 130, 2, 8))
    with pytest.raises(ValueError, match="multiple of"):
        attention.run_attention(q, k, k, cfg)
    assert attention.run_attention(q[:, :8], k[:, :8], k[:, :8],
                                   cfg).shape == (1, 8, 4, 8)


def test_unknown_attn_impl_raises():
    import dataclasses
    from repro_torch.configs import llama3_2_1b
    from repro_torch.models import attention
    cfg = dataclasses.replace(llama3_2_1b.reduced(), attn_impl="flash")
    q = torch.zeros((1, 8, 4, 8))
    k = torch.zeros((1, 8, 2, 8))
    with pytest.raises(ValueError, match="unknown attn_impl"):
        attention.run_attention(q, k, k, cfg)


def test_cuda_only_wrappers_raise_for_cpu_tensors():
    """The kernel wrappers take CUDA tensors only; ``ops`` sends CPU
    tensors to the plain versions before they are reached."""
    from repro_torch.core.search import SearchConfig, problem_arrays
    from repro_torch.kernels import cgp_sim, flash_attention
    q = torch.zeros((1, 4, 8, 8))
    with pytest.raises(ValueError, match="no flash_attention kernel"):
        flash_attention.flash_attention(q, q, q)
    gold, spec, planes, gvals, _ = problem_arrays(
        SearchConfig(width=2, kind="mul", n_n=20), "cpu")
    for layout in cgp_sim.LAYOUTS:
        with pytest.raises(ValueError, match="no cgp_sim kernel"):
            cgp_sim.cgp_sim_metrics_batched(
                gold.nodes[None], gold.outs[None], planes, gvals,
                n_i=spec.n_i, n_n=spec.n_n, n_o=spec.n_o, layout=layout)
    assert cgp_sim.LAUNCHES == cgp_sim.CUBE_LAUNCHES == 0
    assert flash_attention.LAUNCHES == 0


def test_no_environment_knobs():
    """No port module or kernel source reads the environment to pick a
    kernel or a path."""
    for path in PORT_FILES + CUDA_FILES:
        src = open(path).read()
        assert "os.environ" not in src and "getenv" not in src, path


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO, env=dict(os.environ,
                                            CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_commit_worker_gets_host_arrays_only(tmp_path, monkeypatch):
    """The background committer is handed numpy arrays only: no tensor (and
    so no CUDA call) reaches its worker thread."""
    from repro_torch.core import commit
    from repro_torch.core.evolve import EvolveConfig
    from repro_torch.core.fitness import ConstraintSpec
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.sweep import SweepConfig, run_sweep_batched
    handed = []
    real = commit.ChunkCommitter.submit

    def recording(self, fn, *args, **kwargs):
        handed.append((args, kwargs))
        return real(self, fn, *args, **kwargs)

    monkeypatch.setattr(commit.ChunkCommitter, "submit", recording)

    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                yield from leaves(v)
        else:
            yield x

    run_sweep_batched(
        SearchConfig(width=2, kind="add", n_n=20,
                     evolve=EvolveConfig(generations=3, lam=2)),
        [ConstraintSpec(mae=1.0)], (0, 1, 2), SweepConfig(
            chunk_size=2, results_dir=str(tmp_path / "r"),
            checkpoint_dir=str(tmp_path / "c"), async_commit=True),
        device="cpu")
    assert len(handed) == 4          # two shards and two checkpoints
    found = list(leaves(handed))
    assert not [x for x in found if isinstance(x, torch.Tensor)]
    assert any(isinstance(x, np.ndarray) for x in found)
