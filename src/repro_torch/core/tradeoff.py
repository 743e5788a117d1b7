"""Exploration-vs-transmission budget constants (paper §3.3). The closed
form the controller evaluates is fleet/step._plan."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BudgetConfig:
    fps: float = 15.0
    rotation_speed: float = 400.0     # degrees/sec
    hop_degrees: float = 30.0         # grid step (matches OrientationGrid)
    approx_infer_s: float = 0.0067    # EfficientDet-D0-class on edge GPU
    backend_infer_s: float = 0.010    # workload inference per frame
    frame_bytes: int = 25_000         # delta-encoded orientation frame
    min_send: int = 1
    max_send: int = 4
    # pipeline stages across timesteps (radio sends step t while the
    # motor explores t+1); False = paper-strict serial accounting
    pipelined: bool = False

    @property
    def timestep(self) -> float:
        return 1.0 / self.fps
