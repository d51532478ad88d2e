"""Phenotype-keyed evaluation cache of the dedup sweep (``core.sweep``).

CGP point mutation is mostly neutral, so much of every (chunk × λ)
offspring population shares its active subgraph with its parent or a
sibling.  With ``SweepConfig.dedup`` the sweep evaluates each generation's
unique phenotypes only, and this host-side LRU skips the kernel for
phenotypes it has already measured:

  * keys are ``(phenotype digest, grid fingerprint, gauss_sigma)`` tuples
    (plus the sample stream's fingerprint for sampled grids): the digest
    names the active subgraph (``genome.phenotype_digests``), the
    fingerprint the problem, σ the histogram's bin edges, so an entry never
    leaks across problems or σ groups;
  * values are the phenotype-invariant part of an evaluation, the
    ``(metric_vec, power)`` pair.  Raw popcounts are not cached: they are
    indexed by node position, which differs between genotypes of one
    phenotype.  The power is the same for all of them: inactive positions
    add exact zeros to its sum, and the active terms are the same values;
  * the bound counts entries (one entry is a digest and 8 float32s), with
    strict least-recently-used eviction, and every lookup, insert and
    eviction is counted (``CacheStats``).

The cache never changes results (dedup on equals dedup off, which the tests
show), so bounding or dropping it is always safe.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Hashable


@dataclasses.dataclass
class CacheStats:
    """Counters of one dedup cache's life (one sweep call).

    ``candidates`` counts every offspring the dedup loop saw; ``evaluated``
    the unique phenotypes that reached the kernel.  ``hit_rate`` is the
    share of candidate evaluations avoided, by a cross-generation LRU hit
    or by a duplicate inside one generation.
    """
    candidates: int = 0     # offspring seen by the dedup loop
    evaluated: int = 0      # unique phenotypes sent to the kernel
    lru_hits: int = 0       # avoided by a cross-generation cache entry
    dup_hits: int = 0       # avoided by a duplicate inside one generation
    inserts: int = 0        # new keys stored (inserts == live + evictions)
    overwrites: int = 0     # puts that replaced an existing key's value
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        if self.candidates == 0:
            return 0.0
        return 1.0 - self.evaluated / self.candidates

    def as_dict(self) -> dict:
        return {
            "candidates": self.candidates,
            "evaluated": self.evaluated,
            "lru_hits": self.lru_hits,
            "dup_hits": self.dup_hits,
            "inserts": self.inserts,
            "overwrites": self.overwrites,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }


class PhenotypeLRU:
    """Bounded host-side LRU over phenotype-keyed evaluation results."""

    def __init__(self, max_entries: int = 1 << 16):
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        self.max_entries = int(max_entries)
        self._store: OrderedDict[Hashable, object] = OrderedDict()
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._store

    def get(self, key: Hashable):
        """The value of ``key`` (made most recently used), or None."""
        val = self._store.get(key)
        if val is not None:
            self._store.move_to_end(key)
        return val

    def put(self, key: Hashable, value) -> None:
        if key in self._store:
            self._store.move_to_end(key)
            self.stats.overwrites += 1
        else:
            self.stats.inserts += 1
        self._store[key] = value
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)
            self.stats.evictions += 1

    def clear(self) -> None:
        self._store.clear()
