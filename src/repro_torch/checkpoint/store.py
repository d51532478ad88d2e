"""Atomic file commits and step checkpoints.

The port's copy of ``repro.checkpoint.store``: ``atomic_write_json`` and
``atomic_save_npz``, and the step checkpoints (``save_checkpoint``,
``committed_steps``, ``latest_step``, ``load_metadata``,
``load_checkpoint``, ``cleanup``) in the reference's on-disk layout, so a
checkpoint written by either package loads into the other.

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
from typing import Any

import numpy as np


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
#   leaf_<i>.npy    one array per key of the dict, keys in sorted order:
#                   ``jax.tree_util.tree_flatten``'s order for a dict, so a
#                   checkpoint written by either package loads into the
#                   other with no leaf swapped
#   _COMPLETE       commit marker
# A step is written under ``step_<N>.tmp`` and renamed, so a crash mid-save
# never damages the newest committed step.

_MARKER = "_COMPLETE"


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save_checkpoint(ckpt_dir: str, step: int, tree: dict[str, Any],
                    metadata: dict | None = None) -> str:
    """Atomic synchronous save of the arrays of ``tree`` as step ``step``.
    Returns the step's path."""
    leaves = [tree[k] for k in sorted(tree)]
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
    for i, leaf in enumerate(leaves):
        arr = np.asarray(leaf)
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        manifest["leaves"].append(
            {"shape": list(arr.shape), "dtype": str(arr.dtype)})
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


def load_checkpoint(ckpt_dir: str, step: int, template: dict[str, Any]
                    ) -> tuple[dict[str, np.ndarray], dict]:
    """Load step ``step`` as a dict of ``template``'s keys: numpy arrays,
    each cast to its template array's dtype.  Returns (tree, metadata)."""
    path = _step_dir(ckpt_dir, step)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["n_leaves"] != len(template):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"template {len(template)}: structure changed")
    out = {}
    for i, key in enumerate(sorted(template)):
        tmpl = np.asarray(template[key])
        arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
        if arr.shape != tmpl.shape:
            raise ValueError(f"leaf {i} ({key}): checkpoint {arr.shape} vs "
                             f"template {tmpl.shape}")
        out[key] = arr.astype(tmpl.dtype)
    return {k: out[k] for k in template}, manifest["metadata"]


def cleanup(ckpt_dir: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` steps; remove the older ones."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
