"""Fault-tolerance runtime: heartbeats, straggler detection, retry.

A copy of ``repro/runtime/fault.py`` (pure Python).  These are the
mechanisms (unit-tested with fake clocks) that ``launch/train.py`` wires
together; on a cluster the same objects run per host with the coordination
service providing the failure signal.  Policies implemented:

  * HeartbeatMonitor — per-host liveness with a deadline; dead hosts trigger
    the restore-from-checkpoint path (train loop restarts from the last
    committed step, data pipeline replays deterministically).
  * StragglerDetector — EWMA step-time z-score; flags persistent outliers so
    the scheduler can evict/replace them (mitigation = checkpoint + elastic
    restart on the shrunken/replaced mesh, see checkpoint.store resharding).
  * retry — transient-error wrapper with exponential backoff (I/O, preemption
    races).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class HeartbeatMonitor:
    deadline_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        self._last: dict[str, float] = {}

    def beat(self, host: str) -> None:
        self._last[host] = self.clock()

    def dead_hosts(self) -> list[str]:
        now = self.clock()
        return [h for h, t in self._last.items()
                if now - t > self.deadline_s]

    def alive(self, host: str) -> bool:
        return host not in self.dead_hosts() and host in self._last


@dataclasses.dataclass
class StragglerDetector:
    """Flags hosts whose step time is persistently > threshold× the fleet
    EWMA.  ``observe`` returns the current straggler set."""
    alpha: float = 0.2           # EWMA smoothing
    threshold: float = 1.8       # x fleet mean
    patience: int = 3            # consecutive violations before flagging

    def __post_init__(self):
        self._ewma: dict[str, float] = {}
        self._strikes: dict[str, int] = {}

    def observe(self, host: str, step_time_s: float) -> list[str]:
        prev = self._ewma.get(host, step_time_s)
        self._ewma[host] = (1 - self.alpha) * prev + self.alpha * step_time_s
        fleet = sorted(self._ewma.values())
        median = fleet[len(fleet) // 2]
        if self._ewma[host] > self.threshold * median and len(fleet) > 1:
            self._strikes[host] = self._strikes.get(host, 0) + 1
        else:
            self._strikes[host] = 0
        return [h for h, s in self._strikes.items() if s >= self.patience]


def retry(fn: Callable, retries: int = 3, backoff_s: float = 0.1,
          exceptions: tuple = (OSError, IOError),
          sleep: Callable[[float], None] = time.sleep):
    """Run ``fn`` with exponential-backoff retries on transient errors."""
    last = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except exceptions as e:  # noqa: PERF203
            last = e
            if attempt == retries:
                raise
            sleep(backoff_s * (2 ** attempt))
    raise last  # unreachable


@dataclasses.dataclass
class TrainGuard:
    """Composes the mechanisms into the policy the train loop consumes."""
    monitor: HeartbeatMonitor
    detector: StragglerDetector
    on_failure: Callable[[list[str]], None] = lambda hosts: None

    def step(self, host: str, step_time_s: float) -> dict:
        self.monitor.beat(host)
        stragglers = self.detector.observe(host, step_time_s)
        dead = self.monitor.dead_hosts()
        if dead:
            self.on_failure(dead)
        return {"dead": dead, "stragglers": stragglers}
