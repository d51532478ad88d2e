"""Streaming sweep results: one ``.npz`` shard per chunk, read back lazily.

The port's copy of ``repro.core.results`` (schema v3), byte-compatible with
it: the same field names, dtypes and shapes, the same shard names and the
same ``manifest.json``, so ``repro.core.results.SweepResultReader`` opens a
directory this module wrote and ``SweepResultReader`` here opens one the
JAX package wrote.

  * ``SweepResultWriter`` commits each finished chunk of the sweep as one
    shard (atomic tmp + rename: presence is the commit), named by its
    execution-order span.  The manifest pins the grid fingerprint, the
    schema fingerprint, the history mode, the chunk size and plan, and the
    problem geometry (width / kind / n_n) that the artifact registry
    (``core.artifacts``) needs to replay genomes into LUTs.
  * ``SweepResultReader`` scatters the per-run summary columns back to
    grid order on demand and yields per-generation histories one shard at a
    time, so host memory stays independent of the grid size.

Not ported yet (ROADMAP A6b / A11): resuming into a directory that already
holds committed shards (the writer raises instead of overwriting), the pod
partition of the chunk plan, quarantine of damaged shards, reading schema
v2 directories, and the Pareto feeds (``correlations`` / ``fronts``).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Iterator, Sequence

import numpy as np

from repro_torch.checkpoint.store import atomic_save_npz, atomic_write_json
from repro_torch.core import metrics as M

SCHEMA_VERSION = 3
MANIFEST = "manifest.json"
HISTORY_MODES = ("none", "summary", "full")
_SHARD_RE = re.compile(r"^shard_(\d{8})_(\d{8})\.npz$")

#: summary fields of every shard: name -> (trailing shape spec, dtype); the
#: leading axis is the row axis, symbolic dims resolve against the manifest
SUMMARY_FIELDS = {
    "grid_rows": ((), "int32"),            # grid-order index of each row
    "thresholds": (("n_metrics",), "float32"),
    "parent_nodes": (("n_n", 3), "int32"),
    "parent_outs": (("n_o",), "int32"),
    "best_nodes": (("n_n", 3), "int32"),
    "best_outs": (("n_o",), "int32"),
    "best_fit": ((), "float32"),
    "metrics": (("n_metrics",), "float32"),
    "metrics_stderr": (("n_metrics",), "float32"),  # zeros: exhaustive
    "power_rel": ((), "float32"),
    "feasible": ((), "uint8"),
    "certified_mask": ((), "uint8"),       # 1: metrics exact over the cube
    "error_mean": ((), "float32"),
    "error_std": ((), "float32"),
}

#: per-generation history fields, present unless ``keep_history="none"``
HISTORY_FIELDS = {
    "hist_power_rel": (("gens",), "float32"),
    "hist_fit": (("gens",), "float32"),
    "hist_metrics": (("gens", "n_metrics"), "float32"),
}

#: manifest keys that must agree for a directory to hold the same sweep
_IDENTITY_KEYS = ("grid_fingerprint", "schema_fingerprint", "chunk_size",
                  "keep_history", "n_runs", "schema_version", "n_pods")


def shard_fields(keep_history: str) -> dict:
    """The shard schema of a history mode: summary always, histories on disk
    in both "summary" and "full" mode."""
    fields = dict(SUMMARY_FIELDS)
    if keep_history != "none":
        fields.update(HISTORY_FIELDS)
    return fields


def schema_fingerprint(keep_history: str, dims: dict[str, int]) -> str:
    """Identity of the shard layout: version + field names/shapes/dtypes +
    the resolved symbolic dims (the reference's hash, byte for byte)."""
    ident = {
        "version": SCHEMA_VERSION,
        "fields": {k: [list(s), d] for k, (s, d)
                   in sorted(shard_fields(keep_history).items())},
        "dims": {k: int(v) for k, v in sorted(dims.items())},
    }
    return hashlib.sha256(
        json.dumps(ident, sort_keys=True).encode()).hexdigest()


def _shard_name(start: int, end: int) -> str:
    return f"shard_{start:08d}_{end:08d}.npz"


def _scan_spans(results_dir: str) -> list[tuple[int, int]]:
    """Committed shard spans, sorted by start."""
    spans = []
    for name in os.listdir(results_dir):
        if m := _SHARD_RE.match(name):
            spans.append((int(m.group(1)), int(m.group(2))))
    return sorted(spans)


def _covered(committed: Sequence[tuple[int, int]],
             plan: Sequence[Sequence[int]] | None) -> list[tuple[int, int]]:
    """Committed coverage: the prefix of the chunk plan (or, without a
    plan, the contiguous-from-zero prefix) whose shards are all present.
    Spans past a gap are orphans a resumed sweep would overwrite."""
    have = set(committed)
    out, want = [], 0
    for span in (plan if plan is not None else committed):
        span = tuple(span)
        if span not in have or (plan is None and span[0] != want):
            break
        out.append(span)
        want = span[1]
    return out


class SweepResultWriter:
    """Append-only shard writer for one fingerprinted grid.

    Opening a directory whose manifest describes a different sweep raises.
    Opening one that holds this sweep's committed shards raises too: the
    reference would resume from them, and resume is not ported yet.
    """

    def __init__(self, results_dir: str, *, grid_fingerprint: str,
                 grid_meta: list[dict], n_runs: int, gens: int, n_n: int,
                 n_o: int, keep_history: str, chunk_size: int,
                 chunk_spans: Sequence[tuple[int, int]],
                 problem_meta: dict | None = None):
        if keep_history not in HISTORY_MODES:
            raise ValueError(f"keep_history must be one of {HISTORY_MODES}, "
                             f"got {keep_history!r}")
        self.results_dir = results_dir
        dims = {"gens": gens, "n_metrics": M.N_METRICS, "n_n": n_n,
                "n_o": n_o}
        manifest = {
            "schema_version": SCHEMA_VERSION,
            "grid_fingerprint": grid_fingerprint,
            "schema_fingerprint": schema_fingerprint(keep_history, dims),
            "keep_history": keep_history,
            "chunk_size": int(chunk_size),
            "n_pods": 1,
            "chunk_spans": [[int(s), int(e)] for s, e in chunk_spans],
            "n_runs": int(n_runs),
            "dims": dims,
            "metric_names": list(M.METRIC_NAMES),
            "problem": problem_meta,
            "grid": grid_meta,
        }
        os.makedirs(results_dir, exist_ok=True)
        path = os.path.join(results_dir, MANIFEST)
        if os.path.exists(path):
            with open(path) as f:
                have = json.load(f)
            diff = [k for k in _IDENTITY_KEYS
                    if have.get(k, 1 if k == "n_pods" else None)
                    != manifest[k]]
            if diff:
                raise ValueError(
                    f"results_dir {results_dir!r} holds a different sweep "
                    f"(mismatched: {diff}); use a fresh directory")
            if _scan_spans(results_dir):
                raise NotImplementedError(
                    f"results_dir {results_dir!r} already holds shards of "
                    f"this sweep: resume not ported yet (ROADMAP A6b); use "
                    f"a fresh directory")
        atomic_write_json(path, manifest)
        self.manifest = manifest
        self._fields = shard_fields(keep_history)
        self._dims = dims

    def spans(self) -> list[tuple[int, int]]:
        """All committed shard spans (execution order), sorted."""
        return _scan_spans(self.results_dir)

    def write_chunk(self, span: tuple[int, int],
                    rows: dict[str, np.ndarray]) -> str:
        """Atomically commit one chunk's rows (exactly the schema's fields,
        ``end - start`` rows each, ``grid_rows`` included) as a shard."""
        start, end = span
        n = end - start
        if set(rows) != set(self._fields):
            raise ValueError(f"shard fields {sorted(rows)} != schema "
                             f"{sorted(self._fields)}")
        out = {}
        for key, (shape, dtype) in self._fields.items():
            want = (n,) + tuple(self._dims[d] if isinstance(d, str) else d
                                for d in shape)
            arr = np.ascontiguousarray(rows[key], dtype=dtype)
            if arr.shape != want:
                raise ValueError(f"{key}: shape {arr.shape} != {want}")
            out[key] = arr
        path = os.path.join(self.results_dir, _shard_name(start, end))
        atomic_save_npz(path, out)
        return path


class SweepResultReader:
    """Lazy view over a committed shard set (schema v3, one pod).

    Attributes: ``manifest``, ``n_runs``, ``gens``, ``keep_history``,
    ``fingerprint`` (the grid fingerprint) and ``problem`` (width / kind /
    n_n, or None for writers that passed none).
    """

    def __init__(self, results_dir: str):
        self.results_dir = results_dir
        path = os.path.join(results_dir, MANIFEST)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no results manifest at {path!r}")
        with open(path) as f:
            self.manifest = json.load(f)
        ver = self.manifest["schema_version"]
        if ver != SCHEMA_VERSION:
            raise ValueError(f"shard schema v{ver} not readable: the port "
                             f"reads v{SCHEMA_VERSION} only (ROADMAP A6b)")
        if self.manifest.get("n_pods", 1) != 1:
            raise ValueError("pod-sharded results directories are not "
                             "ported yet (ROADMAP A11)")
        self.n_runs: int = self.manifest["n_runs"]
        self.gens: int = self.manifest["dims"]["gens"]
        self.keep_history: str = self.manifest["keep_history"]
        self.fingerprint: str = self.manifest["grid_fingerprint"]
        self.problem: dict | None = self.manifest.get("problem")

    def spans(self) -> list[tuple[int, int]]:
        """Committed shard spans in execution order (the covered prefix of
        the manifest's chunk plan)."""
        return _covered(_scan_spans(self.results_dir),
                        self.manifest.get("chunk_spans"))

    @property
    def completed(self) -> int:
        return sum(end - start for start, end in self.spans())

    def _shards(self, fields: Sequence[str]) -> Iterator[dict]:
        """``{field: (rows, ...) array}`` per committed shard."""
        for start, end in self.spans():
            path = os.path.join(self.results_dir, _shard_name(start, end))
            with np.load(path) as z:
                yield {k: z[k] for k in fields}

    def done_mask(self) -> np.ndarray:
        """(n_runs,) bool, grid order — rows with committed results."""
        mask = np.zeros(self.n_runs, dtype=bool)
        for rows in self._shards(("grid_rows",)):
            mask[rows["grid_rows"]] = True
        return mask

    def iter_history(self) -> Iterator[tuple[np.ndarray, dict]]:
        """Yield ``(grid_rows, {hist_*: (rows, gens, ...)})`` per shard."""
        if self.keep_history == "none":
            raise ValueError('shards written with keep_history="none" hold '
                             'no per-generation histories')
        for rows in self._shards(("grid_rows",) + tuple(HISTORY_FIELDS)):
            yield rows["grid_rows"], {k: rows[k] for k in HISTORY_FIELDS}

    def summary(self, fields: Sequence[str] | None = None
                ) -> dict[str, np.ndarray]:
        """Summary columns in grid order, ``{field: (n_runs, ...)}`` plus
        ``"done_mask"``; rows not yet committed are zero."""
        if fields is None:
            fields = [k for k in SUMMARY_FIELDS if k != "grid_rows"]
        bad = set(fields) - set(SUMMARY_FIELDS)
        if bad:
            raise ValueError(f"not summary fields: {sorted(bad)} "
                             f"(histories go through iter_history)")
        dims = self.manifest["dims"]
        out, mask = {}, np.zeros(self.n_runs, dtype=bool)
        for key in fields:
            shape, dtype = SUMMARY_FIELDS[key]
            trail = tuple(dims[d] if isinstance(d, str) else d for d in shape)
            out[key] = np.zeros((self.n_runs,) + trail, dtype=dtype)
        for rows in self._shards(("grid_rows",) + tuple(fields)):
            idx = rows["grid_rows"]
            mask[idx] = True
            for key in fields:
                out[key][idx] = rows[key]
        out["done_mask"] = mask
        return out

    def records(self) -> list:
        """Grid-order ``search.CircuitRecord`` rows of every committed run."""
        from repro_torch.core.search import CircuitRecord
        s = self.summary(["parent_nodes", "parent_outs", "metrics",
                          "metrics_stderr", "power_rel", "feasible",
                          "certified_mask", "error_mean", "error_std"])
        grid = self.manifest["grid"]
        return [CircuitRecord(
            genome_nodes=s["parent_nodes"][i],
            genome_outs=s["parent_outs"][i],
            metrics=s["metrics"][i],
            power_rel=float(s["power_rel"][i]),
            constraint=grid[i]["constraint"],
            seed=int(grid[i]["seed"]),
            feasible=bool(s["feasible"][i]),
            error_mean=float(s["error_mean"][i]),
            error_std=float(s["error_std"][i]),
            metrics_stderr=s["metrics_stderr"][i],
            certified=bool(s["certified_mask"][i]))
            for i in np.flatnonzero(s["done_mask"])]
