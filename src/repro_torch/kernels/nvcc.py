"""Build a CUDA C++ source of ``csrc/`` into a shared library with nvcc.

Every kernel of the port has a plain C interface and is loaded with ctypes
(pointers and the stream passed as ``c_void_p``).  ``build`` compiles one
source for ``sm_90a`` into ``build/`` beside this file, at first use, keyed
on a hash of the source and the flags, so a rebuilt source never reuses a
stale library and concurrent builds of the same source agree (atomic
rename).  Nothing here runs at import time.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildInfo(NamedTuple):
    path: Path
    seconds: float   # 0.0 when the library was already built
    log: str         # nvcc's output (ptxas register / shared memory report)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return nvcc


def build(source: Path) -> BuildInfo:
    """Compile ``source`` into ``build/<stem>_<hash>.so`` (cached)."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"{source.stem}_{tag}.so"
    if path.exists():
        return BuildInfo(path, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return BuildInfo(path, time.perf_counter() - t0, proc.stdout + proc.stderr)
