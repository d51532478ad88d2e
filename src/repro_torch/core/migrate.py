"""Island-model elite migration between sweep pods (``migrate_every``).

A pod-sharded sweep runs disjoint slices of the chunk plan with no
coordination, so pods never profit from each other's discoveries.  This
module adds the island lever at the CHUNK level: each pod's chunk sequence
is cut into epochs of ``migrate_every`` chunks, and

  * after the last chunk of its epoch ``g``, a pod publishes its per-σ
    elite genomes as one fingerprint-stamped, atomically committed
    ``migrants_pod{i}_gen{g}.npz`` in the shared ``results_dir``
    (presence is the commit; a re-publish after a resume writes the same
    bytes);
  * before any chunk of epoch ``e >= 1``, a pod imports the epoch ``e-1``
    files of EVERY pod whose slice holds a complete epoch ``e-1`` (a
    function of the chunk plan alone, never of timing), waiting for a
    laggard up to ``migrate_timeout``;
  * the imported elites of the chunk's σ are merged by ``(power_rel,
    phenotype digest)``, deduplicated by digest, capped at
    ``MIGRATE_TOP_K``, and folded into the chunk's INITIAL population: each
    run adopts the migrant of best Eq. (8)/(9) fitness under its own
    thresholds iff it is STRICTLY better than the golden parent
    (``fold_segment``).

The import set follows the plan, the merge key is the content, and the
adoption is a per-run argmin with first-index ties, so neither the pods'
start order nor the files' arrival order changes a result.  Migration
changes results, so the grid fingerprint gains a ``migrate`` entry when it
is on; with ``migrate_every=0`` fingerprints and shards are the
migration-less sweep's.  Migrant files are byte for byte the JAX package's.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from repro_torch.checkpoint.store import atomic_save_npz
from repro_torch.core.evolve import EvolveState
from repro_torch.core.fitness import fitness as fitness_fn
from repro_torch.core.genome import (CGPSpec, Genome, PHENOTYPE_DIGEST_SIZE,
                                     phenotype_digests)

#: migrants kept per σ group per merge (and per group in a published file).
#: Part of the grid fingerprint's ``migrate`` entry: it changes results.
MIGRATE_TOP_K = 4

#: the arrays of a migrant file, in the order they are written
MIGRANT_KEYS = ("sigma", "nodes", "outs", "power_rel", "digest")


def migrant_name(pod: int, gen: int) -> str:
    return f"migrants_pod{pod}_gen{gen}.npz"


def select_elites(nodes: np.ndarray, outs: np.ndarray, power_rel: np.ndarray,
                  feas: np.ndarray, sigmas: np.ndarray, spec: CGPSpec,
                  top_k: int = MIGRATE_TOP_K) -> dict[str, np.ndarray]:
    """Per-σ elites of one epoch's committed rows, as migrant arrays.

    Only rows feasible under their own run's constraints qualify; per σ the
    survivors are sorted by ``(power_rel, digest)``, deduplicated by digest
    and capped at ``top_k``.  The output depends on the rows alone, not on
    their order.
    """
    digs = phenotype_digests(nodes, outs, spec)
    picked: list[int] = []
    for sig in sorted(set(float(s) for s in sigmas)):
        cand = [i for i in range(len(sigmas))
                if float(sigmas[i]) == sig and feas[i]]
        cand.sort(key=lambda i: (float(power_rel[i]), digs[i]))
        seen: set[bytes] = set()
        for i in cand:
            if digs[i] in seen:
                continue
            seen.add(digs[i])
            picked.append(i)
            if len(seen) == top_k:
                break
    idx = np.asarray(picked, dtype=np.int64)
    dig_arr = np.frombuffer(b"".join(digs[i] for i in picked),
                            dtype=np.uint8).reshape(len(picked),
                                                    PHENOTYPE_DIGEST_SIZE) \
        if picked else np.zeros((0, PHENOTYPE_DIGEST_SIZE), np.uint8)
    return {
        "sigma": np.asarray(sigmas, np.float32)[idx],
        "nodes": np.asarray(nodes, np.int32)[idx],
        "outs": np.asarray(outs, np.int32)[idx],
        "power_rel": np.asarray(power_rel, np.float32)[idx],
        "digest": dig_arr,
    }


class MigrationManager:
    """One pod's migration endpoint: epochs, publishing, importing.

    Args:
      results_dir: the shared sweep directory the migrant files live in.
      pod: this pod's index.
      pod_lens: the length of each pod's slice of the chunk plan; it fixes
        which pods publish which epochs, so the import set is a function of
        the plan alone.
      period: ``migrate_every``, chunks an epoch.
      fingerprint: the grid fingerprint every migrant file is stamped with;
        an import refuses another (a stale file of another grid).
      timeout: seconds to wait for a required peer file before raising.
    """

    def __init__(self, results_dir: str, pod: int, pod_lens: list[int],
                 period: int, fingerprint: str, *, timeout: float = 120.0,
                 top_k: int = MIGRATE_TOP_K, poll: float = 0.05):
        self.results_dir = results_dir
        self.pod = pod
        self.pod_lens = list(pod_lens)
        self.period = period
        self.fingerprint = fingerprint
        self.timeout = timeout
        self.top_k = top_k
        self.poll = poll
        self.stats = {"published": 0, "imported": 0, "adopted": 0,
                      "waited_s": 0.0}
        self._epochs: dict[int, dict[str, np.ndarray]] = {}

    def epoch_of(self, pos: int) -> int:
        """The epoch of a position in this pod's slice."""
        return pos // self.period

    def publishes_at(self, pos: int) -> int | None:
        """The epoch completed at slice position ``pos``, or None (a partial
        last epoch is never published, and never required)."""
        return self.epoch_of(pos) if (pos + 1) % self.period == 0 else None

    def maybe_publish(self, epoch: int, elites: dict[str, np.ndarray]
                      ) -> str | None:
        """Commit this pod's file of ``epoch`` unless it is there already
        (rows restored on resume give the same bytes)."""
        path = os.path.join(self.results_dir, migrant_name(self.pod, epoch))
        if os.path.exists(path):
            return None
        out = dict(elites)
        out["fingerprint"] = np.array(self.fingerprint)
        out["epoch"] = np.array(epoch, np.int64)
        out["pod"] = np.array(self.pod, np.int64)
        atomic_save_npz(path, out)
        self.stats["published"] += 1
        return path

    def publishers(self, epoch: int) -> list[int]:
        """The pods whose slice holds a COMPLETE ``epoch``: the files every
        importer of that epoch waits for."""
        need = (epoch + 1) * self.period
        return [q for q, n in enumerate(self.pod_lens) if n >= need]

    def _load_epoch(self, epoch: int) -> dict[str, np.ndarray]:
        if epoch in self._epochs:
            return self._epochs[epoch]
        parts = []
        for q in self.publishers(epoch):
            path = os.path.join(self.results_dir, migrant_name(q, epoch))
            deadline = time.monotonic() + self.timeout
            while not os.path.exists(path):
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"pod {self.pod}: migrant file {path!r} (epoch "
                        f"{epoch}, pod {q}) still missing after "
                        f"{self.timeout:.0f}s; is that pod running? "
                        f"(relaunch it, raise migrate_timeout, or disable "
                        f"migration)")
                time.sleep(self.poll)
                self.stats["waited_s"] += self.poll
            with np.load(path) as z:
                fp = str(z["fingerprint"][()])
                if fp != self.fingerprint:
                    raise ValueError(
                        f"migrant file {path!r} stamped with a different "
                        f"grid fingerprint ({fp[:12]}... != "
                        f"{self.fingerprint[:12]}...): a stale file of "
                        f"another grid in this results_dir")
                parts.append({k: z[k] for k in MIGRANT_KEYS})
        merged = {k: np.concatenate([p[k] for p in parts])
                  for k in parts[0]} if parts else {
            "sigma": np.zeros((0,), np.float32)}
        self._epochs[epoch] = merged
        return merged

    def candidates(self, epoch: int, sigma: float
                   ) -> tuple[np.ndarray, np.ndarray] | None:
        """The merged ``(nodes, outs)`` import candidates of one σ, in
        ``(power_rel, digest)`` order, deduplicated and capped at
        ``top_k``; None when the epoch published nothing for this σ.  The
        key is the content, so the files' order cannot change the result.
        """
        mig = self._load_epoch(epoch)
        rows = np.flatnonzero(mig["sigma"] == np.float32(sigma))
        if rows.size == 0:
            return None
        order = sorted(rows.tolist(),
                       key=lambda i: (float(mig["power_rel"][i]),
                                      mig["digest"][i].tobytes()))
        seen: set[bytes] = set()
        keep: list[int] = []
        for i in order:
            d = mig["digest"][i].tobytes()
            if d in seen:
                continue
            seen.add(d)
            keep.append(i)
            if len(keep) == self.top_k:
                break
        self.stats["imported"] += len(keep)
        return mig["nodes"][keep], mig["outs"][keep]


def fold_segment(state: EvolveState, mig_nodes: torch.Tensor,
                 mig_outs: torch.Tensor, mig_mv: torch.Tensor,
                 mig_pw: torch.Tensor, thr_mat: torch.Tensor
                 ) -> tuple[EvolveState, int]:
    """Fold evaluated migrants into a chunk's initial state.

    ``mig_*`` carry a leading migrant axis (padded to a power-of-two bucket
    by repeating row 0 after the real rows, so the first-index argmin is
    unaffected).  Per run, the migrant of least Eq. (8)/(9) fitness under
    that run's thresholds replaces the parent iff STRICTLY better; the
    best-ever follows it the same way.  Returns the folded state and the
    number of runs that adopted a migrant.
    """
    fits = fitness_fn(mig_pw[None], mig_mv[None], thr_mat[:, None, :])
    j = fits.argmin(dim=1)              # first index on ties (C,)
    fbest = fits.gather(1, j[:, None])[:, 0]
    sel = Genome(mig_nodes[j], mig_outs[j])
    take = fbest < state.parent_fit

    def pick(flag, a, b):
        return torch.where(flag.reshape(flag.shape + (1,) * (a.dim() - 1)),
                           a, b)

    improves = fbest < state.best_fit
    folded = EvolveState(
        parent=Genome(pick(take, sel.nodes, state.parent.nodes),
                      pick(take, sel.outs, state.parent.outs)),
        parent_fit=torch.where(take, fbest, state.parent_fit),
        parent_metrics=pick(take, mig_mv[j], state.parent_metrics),
        parent_power=torch.where(take, mig_pw[j], state.parent_power),
        best=Genome(pick(improves, sel.nodes, state.best.nodes),
                    pick(improves, sel.outs, state.best.outs)),
        best_fit=torch.where(improves, fbest, state.best_fit),
        key=state.key)
    return folded, int(take.sum())
