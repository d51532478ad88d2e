"""What the benchmark may load: no module under bench/ imports JAX, Flax
or the JAX package (top-level names compared whole, so ``repro_torch``
passes), the references import nothing of the program either, and nothing
reads the JAX package's ``benchmarks/`` folder."""
import ast

import pytest

from conftest import REPO

BENCH = REPO / "bench"
FILES = sorted(BENCH.rglob("*.py"))


def _imports(path):
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module.split(".")[0])
    return mods


def test_files_found():
    names = {p.relative_to(BENCH).as_posix() for p in FILES}
    assert {"run.py", "harness.py", "reference/lm.py",
            "reference/circuit.py", "drivers/sweep.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_jax_or_the_jax_package(path):
    assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "repro_torch" not in _imports(path)
    assert _imports(path) <= {"__future__", "math", "numpy", "torch",
                              "bench"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_nothing_reads_the_jax_benchmarks_folder(path):
    if path.name == "test_bench_imports.py":
        return
    assert "benchmarks/" not in path.read_text()
