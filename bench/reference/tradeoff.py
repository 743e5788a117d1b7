"""Exploration-vs-transmission balancer (paper §3.3).

Each timestep splits into (a) rotating through + approx-scoring explored
orientations and (b) sending the top-k to the backend + running the
workload there; (b) does not overlap (a) because transmission is governed
by global ranks over everything explored.

MadEye sizes k from how much it trusts its approximation models — low
training accuracy or high variance in last-step predictions means ranks
are risky, so send more frames for ground truth — then spends whatever
budget remains on exploration.

Network estimate = harmonic mean of the last 5 transfer rates (robust to
outliers, per adaptive-streaming practice [106]).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BudgetConfig:
    fps: float = 15.0
    rotation_speed: float = 400.0     # degrees/sec
    hop_degrees: float = 30.0         # grid step (matches OrientationGrid)
    approx_infer_s: float = 0.0067    # EfficientDet-D0-class on edge GPU
    backend_infer_s: float = 0.010    # workload inference per frame (TensorRT)
    frame_bytes: int = 25_000         # delta-encoded orientation frame
    min_send: int = 1
    max_send: int = 4
    # Beyond-paper optimization (EXPERIMENTS.md §Perf): pipeline stages
    # across timesteps — the radio transmits step t's frames while the
    # motor explores step t+1. Each stage must fit a timestep, but they
    # no longer compete for the same budget. Default False = paper-strict
    # serial accounting ("transmission ... does not overlap exploration").
    pipelined: bool = False

    @property
    def timestep(self) -> float:
        return 1.0 / self.fps


