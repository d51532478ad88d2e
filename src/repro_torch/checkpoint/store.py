"""Atomic file commits: temp file, fsync, rename, fsync of the directory.

The port's copy of ``repro.checkpoint.store.atomic_write_json`` and
``atomic_save_npz``.  Presence of a file under its final name is the commit
marker every reader relies on (result shards, manifests, registry
artifacts): the data is fsync'd before the rename and the directory after
it, so a crash cannot leave a zero-byte or truncated file under a committed
name.
"""
from __future__ import annotations

import json
import os
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
