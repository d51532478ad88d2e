"""Fingerprinted circuit-artifact registry: the evolve → LUT → serve bridge.

The port's copy of ``repro.core.artifacts``, file-compatible with it: a
registry either package writes passes the other's ``verify_registry``.

  * ``export_elites`` reads a sweep ``results_dir`` (``core.results``),
    picks per-constraint elites (feasible rows, certified first, lowest
    relative power) and writes each as one self-contained ``.npz``: the
    ``(2^w, 2^w)`` product LUT replayed from the genome
    (``core.library.multiplier_lut``), the genome, the exact metrics, the
    thresholds, the sweep's grid fingerprint and a sha256 content digest
    over all of it, plus a ``registry.json`` index.  Writes are atomic
    (``checkpoint.store``).
  * ``load_artifact`` is the verify path: it recomputes the digest and
    replays the genome, and refuses the artifact on any mismatch.

Digest: sha256 over every payload array's (name, dtype string, shape,
bytes) in sorted key order, ``digest`` itself excluded.  Genome replay runs
on the CPU: it is a host-side check of a few hundred gates, not serving
work.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from repro_torch.checkpoint.store import atomic_save_npz, atomic_write_json
from repro_torch.core import metrics as M

ARTIFACT_SCHEMA_VERSION = 1
REGISTRY = "registry.json"

#: payload keys covered by the content digest; load_artifact refuses
#: artifacts that miss any
_PAYLOAD_KEYS = (
    "schema_version", "kind", "width", "n_n",
    "lut", "genome_nodes", "genome_outs",
    "metrics", "metrics_stderr", "thresholds",
    "power_rel", "error_mean", "error_std",
    "feasible", "certified", "seed", "gauss_sigma",
    "constraint", "grid_fingerprint", "grid_row",
)


@dataclasses.dataclass(frozen=True)
class ExportPolicy:
    """Elite selection of ``export_elites``: rows grouped by (constraint,
    gauss σ), ranked certified first, then by ascending relative power."""
    top_k: int = 1                  # artifacts per constraint group
    feasible_only: bool = True      # drop constraint-violating rows
    require_certified: bool = False  # hard-require exact-certified metrics


@dataclasses.dataclass
class Artifact:
    """One loaded (and, by default, verified) registry artifact."""
    lut: np.ndarray                 # (2^w, 2^w) int32 product table
    genome_nodes: np.ndarray        # (n_n, 3) int32
    genome_outs: np.ndarray         # (n_o,) int32
    width: int
    kind: str
    n_n: int
    metrics: np.ndarray             # (N_METRICS,) float32
    metrics_stderr: np.ndarray      # (N_METRICS,) float32
    thresholds: np.ndarray          # (N_METRICS,) float32
    power_rel: float
    error_mean: float
    error_std: float
    feasible: bool
    certified: bool
    seed: int
    gauss_sigma: float
    constraint: str
    grid_fingerprint: str
    grid_row: int
    digest: str
    path: str | None = None

    def metric_dict(self) -> dict[str, float]:
        return {n: float(v) for n, v in zip(M.METRIC_NAMES, self.metrics)}


def content_digest(payload: dict[str, np.ndarray]) -> str:
    """sha256 over (name, dtype, shape, bytes) of every payload array in
    sorted key order; ``digest`` itself is excluded."""
    h = hashlib.sha256()
    for key in sorted(payload):
        if key == "digest":
            continue
        arr = np.ascontiguousarray(payload[key])
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _recompute_lut(nodes: np.ndarray, outs: np.ndarray, width: int,
                   n_n: int, n_o: int) -> np.ndarray:
    """Replay the genome through the simulator: the authoritative LUT."""
    from repro_torch.core.genome import CGPSpec, Genome
    from repro_torch.core.library import multiplier_lut
    genome = Genome(torch.as_tensor(np.asarray(nodes, np.int32)),
                    torch.as_tensor(np.asarray(outs, np.int32)))
    return multiplier_lut(genome, CGPSpec(2 * width, n_o, n_n))


def _group_rows(grid: list[dict]) -> dict[tuple, list[int]]:
    """Grid-order row indices grouped by (constraint, gauss σ)."""
    groups: dict[tuple, list[int]] = {}
    for i, g in enumerate(grid):
        key = (g["constraint"], float(g.get("gauss_sigma", 0.0)))
        groups.setdefault(key, []).append(i)
    return groups


def export_elites(results_dir: str, out_dir: str,
                  policy: ExportPolicy | None = None, *,
                  width: int | None = None,
                  kind: str | None = None) -> dict:
    """Export per-constraint elite circuits of a sweep as LUT artifacts.

    ``out_dir`` receives one ``.npz`` per elite and ``registry.json``;
    re-exporting the same sweep is idempotent (names embed the digest), and
    a directory holding another grid's registry is refused.  ``width`` /
    ``kind`` must agree with the manifest's ``problem`` block, or stand in
    for it where a writer recorded none.  Returns the registry dict.
    """
    from repro_torch.core.results import SweepResultReader
    policy = policy or ExportPolicy()
    reader = SweepResultReader(results_dir)
    problem = reader.manifest.get("problem") or {}
    if width is None:
        width = problem.get("width")
    elif problem.get("width") not in (None, width):
        raise ValueError(f"width={width} contradicts the results manifest "
                         f"(problem.width={problem['width']})")
    if kind is None:
        kind = problem.get("kind", "mul")
    if width is None:
        raise ValueError(
            f"results manifest at {results_dir!r} predates problem metadata "
            f"— pass width= (and kind=) explicitly")
    if kind != "mul":
        raise ValueError(f"LUT artifacts are multiplier deployments; "
                         f"kind={kind!r} is not exportable")

    dims = reader.manifest["dims"]
    s = reader.summary(["parent_nodes", "parent_outs", "metrics",
                        "metrics_stderr", "power_rel", "feasible",
                        "certified_mask", "thresholds", "error_mean",
                        "error_std"])
    grid = reader.manifest["grid"]

    reg_path = os.path.join(out_dir, REGISTRY)
    if os.path.exists(reg_path):
        with open(reg_path) as f:
            have = json.load(f)
        if have.get("grid_fingerprint") != reader.fingerprint:
            raise ValueError(
                f"registry {out_dir!r} holds a different sweep "
                f"(fingerprint {have.get('grid_fingerprint')!r} != "
                f"{reader.fingerprint!r}); use a fresh directory")

    entries = []
    os.makedirs(out_dir, exist_ok=True)
    for (constraint, sigma), rows in sorted(_group_rows(grid).items()):
        cand = [i for i in rows if s["done_mask"][i]]
        if policy.feasible_only:
            cand = [i for i in cand if s["feasible"][i]]
        if policy.require_certified:
            cand = [i for i in cand if s["certified_mask"][i]]
        cand.sort(key=lambda i: (-int(s["certified_mask"][i]),
                                 float(s["power_rel"][i]), i))
        for i in cand[:policy.top_k]:
            lut = _recompute_lut(s["parent_nodes"][i], s["parent_outs"][i],
                                 width, dims["n_n"], dims["n_o"])
            payload = {
                "schema_version": np.int32(ARTIFACT_SCHEMA_VERSION),
                "kind": np.str_(kind),
                "width": np.int32(width),
                "n_n": np.int32(dims["n_n"]),
                "lut": np.asarray(lut, np.int32),
                "genome_nodes": np.asarray(s["parent_nodes"][i], np.int32),
                "genome_outs": np.asarray(s["parent_outs"][i], np.int32),
                "metrics": np.asarray(s["metrics"][i], np.float32),
                "metrics_stderr": np.asarray(s["metrics_stderr"][i],
                                             np.float32),
                "thresholds": np.asarray(s["thresholds"][i], np.float32),
                "power_rel": np.float32(s["power_rel"][i]),
                "error_mean": np.float32(s["error_mean"][i]),
                "error_std": np.float32(s["error_std"][i]),
                "feasible": np.uint8(s["feasible"][i]),
                "certified": np.uint8(s["certified_mask"][i]),
                "seed": np.int32(grid[i]["seed"]),
                "gauss_sigma": np.float32(sigma),
                "constraint": np.str_(constraint),
                "grid_fingerprint": np.str_(reader.fingerprint),
                "grid_row": np.int32(i),
            }
            digest = content_digest(payload)
            payload["digest"] = np.str_(digest)
            name = f"{kind}{width}_row{i:05d}_{digest[:12]}.npz"
            atomic_save_npz(os.path.join(out_dir, name), payload)
            entries.append({
                "file": name, "digest": digest, "grid_row": int(i),
                "constraint": constraint, "seed": int(grid[i]["seed"]),
                "gauss_sigma": float(sigma),
                "power_rel": float(s["power_rel"][i]),
                "feasible": bool(s["feasible"][i]),
                "certified": bool(s["certified_mask"][i]),
                "metrics": {n: float(v) for n, v in
                            zip(M.METRIC_NAMES, s["metrics"][i])},
            })

    registry = {
        "schema_version": ARTIFACT_SCHEMA_VERSION,
        "grid_fingerprint": reader.fingerprint,
        "problem": {"width": int(width), "kind": kind,
                    "n_n": int(dims["n_n"])},
        "policy": dataclasses.asdict(policy),
        "source_results_dir": os.path.abspath(results_dir),
        "artifacts": entries,
    }
    atomic_write_json(reg_path, registry)
    return registry


def load_artifact(path: str, *, verify: bool = True,
                  expect_fingerprint: str | None = None) -> Artifact:
    """Load one artifact ``.npz``.  ``verify`` (the default, and what
    serving uses) recomputes the content digest and replays the genome into
    its LUT; any mismatch raises ``ValueError``.  ``expect_fingerprint``
    pins the sweep the artifact must come from."""
    with np.load(path) as z:
        missing = [k for k in _PAYLOAD_KEYS if k not in z]
        if missing:
            raise ValueError(f"artifact {path!r} missing keys {missing}")
        payload = {k: np.asarray(z[k]) for k in z.files}
    ver = int(payload["schema_version"])
    if ver > ARTIFACT_SCHEMA_VERSION:
        raise ValueError(f"artifact schema v{ver} newer than supported "
                         f"v{ARTIFACT_SCHEMA_VERSION}: {path!r}")
    stored_digest = str(payload.get("digest", ""))
    art = Artifact(
        lut=payload["lut"].astype(np.int32),
        genome_nodes=payload["genome_nodes"],
        genome_outs=payload["genome_outs"],
        width=int(payload["width"]),
        kind=str(payload["kind"]),
        n_n=int(payload["n_n"]),
        metrics=payload["metrics"],
        metrics_stderr=payload["metrics_stderr"],
        thresholds=payload["thresholds"],
        power_rel=float(payload["power_rel"]),
        error_mean=float(payload["error_mean"]),
        error_std=float(payload["error_std"]),
        feasible=bool(payload["feasible"]),
        certified=bool(payload["certified"]),
        seed=int(payload["seed"]),
        gauss_sigma=float(payload["gauss_sigma"]),
        constraint=str(payload["constraint"]),
        grid_fingerprint=str(payload["grid_fingerprint"]),
        grid_row=int(payload["grid_row"]),
        digest=stored_digest,
        path=path,
    )
    if expect_fingerprint is not None \
            and art.grid_fingerprint != expect_fingerprint:
        raise ValueError(
            f"artifact {path!r} comes from grid "
            f"{art.grid_fingerprint[:12]}…, expected "
            f"{expect_fingerprint[:12]}… — wrong sweep")
    if verify:
        want = content_digest(payload)
        if want != stored_digest:
            raise ValueError(f"artifact {path!r} digest mismatch "
                             f"(stored {stored_digest[:12]}…, content "
                             f"{want[:12]}…) — refusing corrupt artifact")
        replayed = _recompute_lut(art.genome_nodes, art.genome_outs,
                                  art.width, art.n_n,
                                  art.genome_outs.shape[0])
        if not np.array_equal(replayed, art.lut):
            raise ValueError(f"artifact {path!r} LUT does not match its "
                             f"genome replay — refusing tampered artifact")
    return art


def load_registry(registry_dir: str) -> dict:
    path = os.path.join(registry_dir, REGISTRY)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {REGISTRY} in {registry_dir!r} "
                                f"(run export_elites first)")
    with open(path) as f:
        return json.load(f)


def verify_registry(registry_dir: str) -> list[Artifact]:
    """Verify every registry entry (digest, genome replay, fingerprint and
    the registry's own digest index); returns the loaded artifacts and
    raises on the first failure."""
    reg = load_registry(registry_dir)
    arts = []
    for entry in reg["artifacts"]:
        art = load_artifact(os.path.join(registry_dir, entry["file"]),
                            verify=True,
                            expect_fingerprint=reg["grid_fingerprint"])
        if art.digest != entry["digest"]:
            raise ValueError(f"registry digest for {entry['file']} "
                             f"({entry['digest'][:12]}…) != artifact digest "
                             f"({art.digest[:12]}…)")
        arts.append(art)
    return arts


def select_artifact(registry_dir: str, *, constraint: str | None = None,
                    certified_only: bool = False) -> str:
    """The path of the lowest-power feasible entry (certified entries
    first), optionally among constraints containing ``constraint``."""
    reg = load_registry(registry_dir)
    cand = [e for e in reg["artifacts"] if e["feasible"]]
    if constraint is not None:
        cand = [e for e in cand if constraint in e["constraint"]]
    if certified_only:
        cand = [e for e in cand if e["certified"]]
    if not cand:
        raise ValueError(f"no matching artifact in {registry_dir!r} "
                         f"(constraint={constraint!r}, "
                         f"certified_only={certified_only})")
    best = min(cand, key=lambda e: (-int(e["certified"]), e["power_rel"],
                                    e["grid_row"]))
    return os.path.join(registry_dir, best["file"])


def resolve_artifact(path: str, *, verify: bool = True) -> Artifact:
    """Load an artifact from a ``.npz`` path or a registry directory (its
    ``select_artifact`` entry): the form ``serve --approx-lut`` accepts."""
    if os.path.isdir(path):
        path = select_artifact(path)
    return load_artifact(path, verify=verify)
