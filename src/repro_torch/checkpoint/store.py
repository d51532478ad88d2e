"""Atomic file commits and step checkpoints.

The port's copy of ``repro.checkpoint.store``: ``atomic_write_json`` and
``atomic_save_npz``, and the step checkpoints (``save_checkpoint``,
``AsyncCheckpointer``, ``committed_steps``, ``latest_step``,
``load_metadata``, ``load_checkpoint``, ``cleanup``) in the reference's
on-disk layout, so a checkpoint written by either package loads into the
other.  A checkpoint is a nested dict of arrays (numpy arrays or tensors);
bfloat16 leaves are written as the reference writes them, 2-byte void
records (``'<V2'``) holding the bfloat16 bits, and read back by bit view.

Presence of a file under its final name is the commit marker every reader
relies on (result shards, manifests, registry artifacts): the data is
fsync'd before the rename and the directory after it, so a crash cannot
leave a zero-byte or truncated file under a committed name.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch import tree as T

BF16_RECORD = np.dtype("V2")   # numpy's stand-in for a bfloat16 leaf


def _fsync_path(path: str) -> None:
    """fsync a file or directory by path."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_json(path: str, obj: Any) -> None:
    """Write JSON through a unique temp file + fsync + rename, so readers
    never see a partial file and concurrent writers of identical bytes do
    not truncate each other (last rename wins)."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".tmp.")
    try:
        # mkstemp creates 0600; give the mode a plain open() would
        umask = os.umask(0)
        os.umask(umask)
        os.fchmod(fd, 0o666 & ~umask)
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=1, default=float)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_path(os.path.dirname(path) or ".")
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def atomic_save_npz(path: str, arrays: dict[str, np.ndarray]) -> None:
    """Commit an ``.npz`` bundle atomically: it exists complete or not at
    all; a failure removes the temp file and leaves ``path`` untouched."""
    tmp = path + ".tmp.npz"
    try:
        np.savez(tmp, **arrays)
        _fsync_path(tmp)
        os.replace(tmp, path)
        _fsync_path(os.path.dirname(path) or ".")
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


# -- step checkpoints -------------------------------------------------------
#
# Layout (the reference's, file for file):  <dir>/step_<N>/
#   manifest.json   step, n_leaves, metadata, and each leaf's shape / dtype
#   leaf_<i>.npy    one array per leaf of the tree, dict keys sorted at
#                   every level: ``jax.tree_util.tree_flatten``'s order for
#                   nested dicts, so a checkpoint written by either package
#                   loads into the other with no leaf swapped
#   _COMPLETE       commit marker
# A step is written under ``step_<N>.tmp`` and renamed, so a crash mid-save
# never damages the newest committed step.

_MARKER = "_COMPLETE"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def to_host(x) -> np.ndarray:
    """A leaf as a numpy array of its own (a copy); a bfloat16 tensor as
    2-byte void records of its bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_RECORD)
        return t.numpy()
    return np.array(x)


def _save_leaf(path: str, arr: np.ndarray) -> str:
    """Write one leaf; returns the dtype name the manifest records."""
    if arr.dtype != BF16_RECORD:
        np.save(path, arr)
        return str(arr.dtype)
    # the header ``np.save`` writes for a bfloat16 array (ml_dtypes)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())
    return "bfloat16"


def save_checkpoint(ckpt_dir: str, step: int, tree: dict[str, Any],
                    metadata: dict | None = None) -> str:
    """Atomic synchronous save of the leaves of ``tree`` (a nested dict of
    numpy arrays or tensors) as step ``step``.  Returns the step's path."""
    leaves = [to_host(x) if isinstance(x, torch.Tensor) else np.asarray(x)
              for x in T.leaves(tree)]
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = {
        "step": step,
        "treedef": None,  # the reference writes no tree structure either
        "n_leaves": len(leaves),
        "metadata": metadata or {},
        "leaves": [],
    }
    for i, arr in enumerate(leaves):
        dtype = _save_leaf(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        manifest["leaves"].append({"shape": list(arr.shape), "dtype": dtype})
    atomic_write_json(os.path.join(tmp, "manifest.json"), manifest)
    with open(os.path.join(tmp, _MARKER), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _fsync_path(ckpt_dir)
    return final


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training: ``save`` copies the tree to
    the host before it returns (the caller may overwrite its tensors at
    once) and writes it on a background thread, one save in flight (a
    second ``save`` waits for the first).  ``wait`` joins the write and
    raises its error, if any.  ``write_seconds`` holds each finished
    write's duration on the writer thread."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.write_seconds: list[float] = []

    def save(self, ckpt_dir: str, step: int, tree: dict[str, Any],
             metadata: dict | None = None) -> None:
        self.wait()
        host_tree = T.map(to_host, tree)

        def write():
            try:
                t0 = time.perf_counter()
                save_checkpoint(ckpt_dir, step, host_tree, metadata)
                self.write_seconds.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — re-raised by wait
                self._error = e
        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def committed_steps(ckpt_dir: str) -> list[int]:
    """Every committed step number, ascending: ``.tmp`` directories and
    steps without the commit marker are not committed."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, _MARKER)):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    steps = committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_metadata(ckpt_dir: str, step: int) -> dict:
    """A step's metadata alone (the identity check before a full load)."""
    with open(os.path.join(_step_dir(ckpt_dir, step), "manifest.json")) as f:
        return json.load(f)["metadata"]


def _as_template(arr: np.ndarray, tmpl, where: str):
    if tuple(arr.shape) != tuple(tmpl.shape):
        raise ValueError(f"{where}: checkpoint {tuple(arr.shape)} vs "
                         f"template {tuple(tmpl.shape)}")
    if isinstance(tmpl, torch.Tensor):
        if arr.dtype == BF16_RECORD:
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device=tmpl.device, dtype=tmpl.dtype)
    tmpl = np.asarray(tmpl)
    if arr.dtype == BF16_RECORD and tmpl.dtype != BF16_RECORD:
        arr = torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).float().numpy()
    return arr.astype(tmpl.dtype)


def load_checkpoint(ckpt_dir: str, step: int, template: dict[str, Any],
                    shardings: dict[str, Any] | None = None
                    ) -> tuple[dict[str, Any], dict]:
    """Load step ``step`` into the structure of ``template`` (a nested
    dict).  Where the template's leaf is a tensor the result is a tensor of
    its dtype on its device, else a numpy array cast to the leaf's dtype.
    Returns (tree, metadata).

    ``shardings``: a tree of ``parallel.ctx.Sharding`` (or None leaves)
    matching ``template``, whose leaves are then this rank's slices: each
    takes its slice of the whole leaf on disk (read through a memory map),
    so a checkpoint written on one mesh, or by either package on one
    device, restores onto any mesh."""
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    tmpl_leaves = T.leaves(template)
    if manifest["n_leaves"] != len(tmpl_leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"template {len(tmpl_leaves)}: structure changed")
    shard_leaves = (T.leaves(shardings) if shardings is not None
                    else [None] * len(tmpl_leaves))
    out = []
    for i, (tmpl, sh) in enumerate(zip(tmpl_leaves, shard_leaves)):
        arr = np.load(os.path.join(path, f"leaf_{i}.npy"),
                      mmap_mode="r" if sh is not None else None)
        if sh is not None:
            arr = np.ascontiguousarray(arr[sh.index(arr.shape)])
        out.append(_as_template(arr, tmpl, f"leaf {i}"))
    return T.unflatten(template, out), manifest["metadata"]


def gather_to_host(tree: dict[str, Any], shardings: dict[str, Any],
                   writer: bool) -> dict[str, Any] | None:
    """The whole leaves of a tree of this rank's slices (``shardings`` as
    in ``load_checkpoint``), gathered leaf by leaf (every rank takes part)
    and copied to the host on the ``writer`` alone: the tree to save there,
    None elsewhere.  Checkpoints of a sharded run are written whole, in the
    reference's layout, by one writer."""
    from repro_torch.parallel import collectives as coll
    out = []
    for x, sh in zip(T.leaves(tree), T.leaves(shardings)):
        whole = coll.gather(x.detach(), sh)
        out.append(to_host(whole) if writer else None)
        del whole
    return T.unflatten(tree, out) if writer else None


def cleanup(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` steps; remove the older ones."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
