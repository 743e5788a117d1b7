"""Fault tolerance bookkeeping: heartbeats, stragglers, restart decisions.

The control plane a 1000-node job needs, in simulation-testable form:

  * HeartbeatTable — hosts report per-step completion times; missing
    heartbeats past `dead_after_s` mark a host dead;
  * straggler detection — per-step deadline = quantile(history) *
    tolerance; hosts persistently above it get flagged for replacement
    (slow HBM, thermal throttling, failing NIC are the usual culprits);
  * RestartPolicy — decides between in-place continue, elastic shrink
    (train/elastic.py), or full restart from the last checkpoint
    (train/checkpoint.py), with exponential backoff on repeated failures.

Host numpy only; the port keeps its own copy of the reference's module.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class HeartbeatTable:
    n_hosts: int
    dead_after_s: float = 60.0
    last_seen: np.ndarray = field(default=None)
    step_times: dict = field(default_factory=dict)   # host -> list[float]
    window: int = 50

    def __post_init__(self):
        now = time.monotonic()
        if self.last_seen is None:
            self.last_seen = np.full(self.n_hosts, now)

    def beat(self, host: int, step_time_s: float,
             now: float | None = None):
        now = time.monotonic() if now is None else now
        self.last_seen[host] = now
        hist = self.step_times.setdefault(host, [])
        hist.append(step_time_s)
        if len(hist) > self.window:
            hist.pop(0)

    def dead_hosts(self, now: float | None = None) -> list[int]:
        now = time.monotonic() if now is None else now
        return [h for h in range(self.n_hosts)
                if now - self.last_seen[h] > self.dead_after_s]

    def stragglers(self, tolerance: float = 1.5,
                   min_samples: int = 10) -> list[int]:
        """Hosts whose median step time exceeds tolerance x fleet median."""
        medians = {}
        for h, hist in self.step_times.items():
            if len(hist) >= min_samples:
                medians[h] = float(np.median(hist))
        if len(medians) < 2:
            return []
        fleet = float(np.median(list(medians.values())))
        return [h for h, m in medians.items() if m > tolerance * fleet]


@dataclass
class RestartPolicy:
    max_restarts: int = 10
    backoff_base_s: float = 5.0
    restarts: int = 0

    def decide(self, n_dead: int, n_total: int,
               model_parallel: int) -> str:
        """-> 'continue' | 'elastic_shrink' | 'full_restart' | 'abort'."""
        if n_dead == 0:
            return "continue"
        if self.restarts >= self.max_restarts:
            return "abort"
        surviving = n_total - n_dead
        # elastic shrink only if the surviving mesh keeps TP groups whole
        if surviving % model_parallel == 0 and surviving > 0:
            return "elastic_shrink"
        return "full_restart"

    def backoff_s(self) -> float:
        self.restarts += 1
        return self.backoff_base_s * (2 ** min(self.restarts - 1, 6))


def deadline_for_step(history_s: list, quantile: float = 0.99,
                      tolerance: float = 2.0, floor_s: float = 1.0) -> float:
    """Per-step watchdog deadline from recent history (straggler
    mitigation: steps past it trigger within-step work re-dispatch or a
    checkpoint-skip of the slow host's shard)."""
    if not history_s:
        return floor_s * tolerance
    q = float(np.quantile(np.asarray(history_s), quantile))
    return max(q * tolerance, floor_s)
