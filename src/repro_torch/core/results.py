"""Streaming sweep results: one ``.npz`` shard per chunk, read back lazily.

The port's copy of ``repro.core.results`` (schema v3), byte-compatible with
it: the same field names, dtypes and shapes, the same shard names and the
same ``manifest.json``, so ``repro.core.results.SweepResultReader`` opens a
directory this module wrote and ``SweepResultReader`` here opens one the
JAX package wrote, and either package resumes the other's sweep.

  * ``SweepResultWriter`` commits each finished chunk of the sweep as one
    shard (atomic tmp + rename: presence is the commit), named by its
    execution-order span.  The manifest pins the grid fingerprint, the
    schema fingerprint, the history mode, the chunk size, the pod count and
    the chunk plan, and the problem geometry (width / kind / n_n) that the
    artifact registry (``core.artifacts``) needs to replay genomes into
    LUTs.  The shard set is the sweep's resume state: ``restore`` scatters
    the committed coverage back into the sweep's buffers and quarantines a
    damaged shard (``<name>.corrupt``), whose chunk then runs again.
  * ``SweepResultReader`` scatters the per-run summary columns back to
    grid order on demand and yields per-generation histories one shard at a
    time, so host memory stays independent of the grid size.  It reads
    schema v2 directories too (``certified_mask`` reads as 0) and
    directories of any pod count.  ``correlations`` / ``fronts`` feed
    ``core.pareto`` the arrays the in-RAM ``SweepResult`` feeds it.

The chunk plan is partitioned round-robin over pods (``pod_partition``);
committed coverage is the union of each pod's committed prefix of its own
spans (``pod_prefix_spans``), which for one pod is the committed prefix of
the plan.  The port's sweep runs and resumes one pod; its reader opens
directories that several pods of the JAX package wrote.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import sys
import zipfile
from typing import Iterator, Sequence

import numpy as np

from repro_torch.checkpoint.store import atomic_save_npz, atomic_write_json
from repro_torch.core import metrics as M
from repro_torch.core import pareto

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

#: summary fields that older schema versions the reader accepts lack, by
#: manifest version: reads leave the dtype's zero in their place
#: (``certified_mask`` 0: nothing in a v2 directory was certified)
READ_DEFAULTS = {2: frozenset({"certified_mask"})}
MIN_READ_VERSION = min(READ_DEFAULTS, default=SCHEMA_VERSION)

#: per-generation history fields, present unless ``keep_history="none"``
HISTORY_FIELDS = {
    "hist_power_rel": (("gens",), "float32"),
    "hist_fit": (("gens",), "float32"),
    "hist_metrics": (("gens", "n_metrics"), "float32"),
}

#: manifest keys that must agree for a directory to hold the same sweep
_IDENTITY_KEYS = ("grid_fingerprint", "schema_fingerprint", "chunk_size",
                  "keep_history", "n_runs", "schema_version", "n_pods")


def normalize_history_mode(keep_history) -> str:
    """The history mode of ``keep_history``: the legacy bools map to
    ``"full"`` (True) and ``"none"`` (False); strings must be one of
    ``HISTORY_MODES``."""
    if keep_history is True:
        return "full"
    if keep_history is False:
        return "none"
    if keep_history not in HISTORY_MODES:
        raise ValueError(
            f"keep_history must be one of {HISTORY_MODES} (or a legacy "
            f"bool), got {keep_history!r}")
    return keep_history


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


def _prefix_spans(spans: Sequence[tuple[int, int]]) -> list[tuple[int, int]]:
    """The contiguous-from-zero prefix of a sorted span list: the coverage
    of a directory whose manifest pins no ``chunk_spans`` plan.  Spans past
    a gap are orphans a resumed sweep overwrites with identical bytes."""
    out, want = [], 0
    for start, end in spans:
        if start != want:
            break
        out.append((start, end))
        want = end
    return out


def pod_partition(chunk_spans: Sequence[tuple[int, int]],
                  n_pods: int) -> list[list[tuple[int, int]]]:
    """Round-robin assignment of the execution-order chunk spans to pods:
    pod ``p`` owns ``chunk_spans[p::n_pods]``."""
    if n_pods < 1:
        raise ValueError(f"n_pods must be >= 1, got {n_pods}")
    return [list(chunk_spans[p::n_pods]) for p in range(n_pods)]


def pod_prefix_spans(committed: Sequence[tuple[int, int]],
                     chunk_spans: Sequence[tuple[int, int]],
                     n_pods: int) -> list[tuple[int, int]]:
    """Committed coverage of a pod-partitioned plan: the union over pods of
    each pod's committed prefix of its own span sequence, sorted.  Pods
    commit independently, so the union may have gaps; spans past a gap in
    a pod's own sequence are orphans, as in ``_prefix_spans`` (to which
    this reduces for one pod)."""
    have = set(map(tuple, committed))
    out: list[tuple[int, int]] = []
    for pod_seq in pod_partition([tuple(s) for s in chunk_spans], n_pods):
        for span in pod_seq:
            if span not in have:
                break
            out.append(span)
    return sorted(out)


def _live_spans(results_dir: str, manifest: dict) -> list[tuple[int, int]]:
    """Committed coverage of ``results_dir`` under its manifest's plan."""
    committed = _scan_spans(results_dir)
    plan = manifest.get("chunk_spans")
    if plan is None:
        return _prefix_spans(committed)
    return pod_prefix_spans(committed, [tuple(s) for s in plan],
                            manifest.get("n_pods", 1))


class SweepResultWriter:
    """Append-only shard writer for one fingerprinted grid.

    ``write_chunk`` commits one chunk of run-major rows; ``restore`` is the
    resume path (it scatters the committed coverage back into the sweep's
    buffers).  Opening a directory that holds a different grid (or the same
    grid with another chunk size, history mode or pod count) raises, unless
    ``on_mismatch="reset"``, which empties it and starts again.  A
    directory written before the manifest pinned ``n_pods``,
    ``chunk_spans`` and ``problem`` is upgraded once, in place.
    """

    def __init__(self, results_dir: str, *, grid_fingerprint: str,
                 grid_meta: list[dict], n_runs: int, gens: int, n_n: int,
                 n_o: int, keep_history: str, chunk_size: int,
                 chunk_spans: Sequence[tuple[int, int]],
                 n_pods: int = 1, problem_meta: dict | None = None,
                 on_mismatch: str = "error"):
        self.results_dir = results_dir
        keep_history = normalize_history_mode(keep_history)
        dims = {"gens": gens, "n_metrics": M.N_METRICS, "n_n": n_n,
                "n_o": n_o}
        manifest = {
            "schema_version": SCHEMA_VERSION,
            "grid_fingerprint": grid_fingerprint,
            "schema_fingerprint": schema_fingerprint(keep_history, dims),
            "keep_history": keep_history,
            "chunk_size": int(chunk_size),
            "n_pods": int(n_pods),
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
                if on_mismatch != "reset":
                    raise ValueError(
                        f"results_dir {results_dir!r} holds a different "
                        f"sweep (mismatched: {diff}); use a fresh directory "
                        f"or on_mismatch='reset'")
                for name in os.listdir(results_dir):
                    p = os.path.join(results_dir, name)
                    shutil.rmtree(p) if os.path.isdir(p) else os.remove(p)
                atomic_write_json(path, manifest)
            elif any(k not in have
                     for k in ("n_pods", "chunk_spans", "problem")):
                atomic_write_json(path, manifest)
        else:
            atomic_write_json(path, manifest)
        self.manifest = manifest
        self._fields = shard_fields(keep_history)
        self._dims = dims

    def spans(self) -> list[tuple[int, int]]:
        """All committed shard spans (execution order), sorted."""
        return _scan_spans(self.results_dir)

    def pod_spans(self, pod_index: int) -> list[tuple[int, int]]:
        """The ordered slice of the chunk plan that pod ``pod_index`` owns."""
        return pod_partition([tuple(s) for s in self.manifest["chunk_spans"]],
                             self.manifest["n_pods"])[pod_index]

    def live_spans(self) -> list[tuple[int, int]]:
        """Committed coverage: the union of the pods' committed prefixes of
        the plan."""
        return _live_spans(self.results_dir, self.manifest)

    def coverage(self) -> int:
        """Runs covered by the committed coverage."""
        return sum(end - start for start, end in self.live_spans())

    #: what ``restore`` takes for a damaged shard rather than a bug: a
    #: zero-byte or truncated file, a missing or malformed member, rows out
    #: of range
    _CORRUPT_ERRORS = (OSError, EOFError, ValueError, KeyError, IndexError,
                       zipfile.BadZipFile)

    def _quarantine(self, path: str, err: Exception) -> None:
        """Rename a damaged shard ``<name>.corrupt`` (no longer a committed
        span), so the sweep runs and commits its chunk again."""
        quarantined = path + ".corrupt"
        os.replace(path, quarantined)
        print(f"[results] quarantined damaged shard {path} -> "
              f"{quarantined}: {type(err).__name__}: {err}",
              file=sys.stderr, flush=True)

    def restore(self, bufs: dict[str, np.ndarray]) -> list[tuple[int, int]]:
        """Scatter the committed coverage into the grid-order buffers in
        place (only the keys of ``bufs`` that a shard holds) and return the
        covered spans, the sweep's resume point.  A damaged shard is
        quarantined, its span leaves the coverage, and the scatter starts
        again over what is left (scattering a healthy shard twice writes
        the same rows)."""
        while True:
            live = self.live_spans()
            path = None
            try:
                for start, end in live:
                    path = self._path(start, end)
                    _scatter(path, bufs)
            except self._CORRUPT_ERRORS as e:
                self._quarantine(path, e)
                continue
            return live

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
        path = self._path(start, end)
        atomic_save_npz(path, out)
        return path

    def _path(self, start: int, end: int) -> str:
        return os.path.join(self.results_dir, _shard_name(start, end))


def _scatter(path: str, bufs: dict[str, np.ndarray]) -> None:
    """Scatter one shard's rows into the grid-order ``bufs`` it holds."""
    with np.load(path) as z:
        rows = z["grid_rows"]
        for key in bufs:
            if key in z:
                bufs[key][rows] = z[key]


class SweepResultReader:
    """Lazy view over a committed shard set (schema v2 or v3, any pod
    count).

    Attributes: ``manifest``, ``schema_version``, ``n_runs``, ``gens``,
    ``keep_history``, ``fingerprint`` (the grid fingerprint),
    ``metric_names``, ``n_pods`` and ``problem`` (width / kind / n_n, or
    None for writers that passed none).
    """

    def __init__(self, results_dir: str):
        self.results_dir = results_dir
        path = os.path.join(results_dir, MANIFEST)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no results manifest at {path!r}")
        with open(path) as f:
            self.manifest = json.load(f)
        ver = self.manifest["schema_version"]
        if not MIN_READ_VERSION <= ver <= SCHEMA_VERSION:
            raise ValueError(
                f"shard schema v{ver} not readable by v{SCHEMA_VERSION} "
                f"reader (accepts v{MIN_READ_VERSION}..v{SCHEMA_VERSION})")
        self.schema_version: int = ver
        # fields this directory's shards predate: reads keep the zeros
        self._absent: frozenset = READ_DEFAULTS.get(ver, frozenset())
        self.n_runs: int = self.manifest["n_runs"]
        self.gens: int = self.manifest["dims"]["gens"]
        self.keep_history: str = self.manifest["keep_history"]
        self.fingerprint: str = self.manifest["grid_fingerprint"]
        self.metric_names: list[str] = self.manifest["metric_names"]
        self.n_pods: int = self.manifest.get("n_pods", 1)
        self.problem: dict | None = self.manifest.get("problem")

    def spans(self) -> list[tuple[int, int]]:
        """Committed shard spans in execution order: the union of the pods'
        committed prefixes of the manifest's plan (the contiguous prefix
        when no plan is pinned)."""
        return _live_spans(self.results_dir, self.manifest)

    @property
    def completed(self) -> int:
        return sum(end - start for start, end in self.spans())

    def restore(self, bufs: dict[str, np.ndarray]) -> list[tuple[int, int]]:
        """``SweepResultWriter.restore`` without writing: scatter the
        committed coverage into ``bufs`` and return it.  A damaged shard
        raises here; only a writer quarantines."""
        live = self.spans()
        for start, end in live:
            _scatter(os.path.join(self.results_dir, _shard_name(start, end)),
                     bufs)
        return live

    def iter_shards(self, fields: Sequence[str] | None = None
                    ) -> Iterator[tuple[tuple[int, int], dict]]:
        """Yield ``(span, {field: (rows, ...) array})`` per committed shard,
        loading only ``fields`` (default: every field of the shard); fields
        the directory's schema version predates are left out."""
        for start, end in self.spans():
            path = os.path.join(self.results_dir, _shard_name(start, end))
            with np.load(path) as z:
                keys = (z.files if fields is None
                        else [k for k in fields if k not in self._absent])
                yield (start, end), {k: z[k] for k in keys}

    def done_mask(self) -> np.ndarray:
        """(n_runs,) bool, grid order — rows with committed results."""
        mask = np.zeros(self.n_runs, dtype=bool)
        for _, rows in self.iter_shards(("grid_rows",)):
            mask[rows["grid_rows"]] = True
        return mask

    def iter_history(self) -> Iterator[tuple[np.ndarray, dict]]:
        """Yield ``(grid_rows, {hist_*: (rows, gens, ...)})`` per shard."""
        if self.keep_history == "none":
            raise ValueError('shards written with keep_history="none" hold '
                             'no per-generation histories')
        fields = ("grid_rows",) + tuple(HISTORY_FIELDS)
        for _, rows in self.iter_shards(fields):
            yield rows["grid_rows"], {k: rows[k] for k in HISTORY_FIELDS}

    def summary(self, fields: Sequence[str] | None = None
                ) -> dict[str, np.ndarray]:
        """Summary columns in grid order, ``{field: (n_runs, ...)}`` plus
        ``"done_mask"``; rows not yet committed, and fields the schema
        version predates, are zero."""
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
        for _, rows in self.iter_shards(("grid_rows",) + tuple(fields)):
            idx = rows["grid_rows"]
            mask[idx] = True
            for key in fields:
                if key in rows:
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

    def _masked(self, feasible_only: bool):
        s = self.summary(["metrics", "power_rel", "feasible"])
        mask = s["done_mask"] & (s["feasible"].astype(bool)
                                 if feasible_only else True)
        return s["metrics"][mask], s["power_rel"][mask]

    def correlations(self, feasible_only: bool = True) -> np.ndarray:
        """|Pearson| cross-metric correlations over the committed runs
        (paper Fig. 6): ``SweepResult.correlations``'s answer."""
        metrics, _ = self._masked(feasible_only)
        return pareto.metric_correlations(metrics)

    def fronts(self, metric_indices: Sequence[int] = (M.MAE, M.ER),
               feasible_only: bool = True) -> dict[int, np.ndarray]:
        """Power-vs-metric Pareto fronts (paper Figs. 7-14 axes):
        ``SweepResult.fronts``'s answer."""
        metrics, power = self._masked(feasible_only)
        return pareto.sweep_fronts(power, metrics, metric_indices)
