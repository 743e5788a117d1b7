"""Zoom-controller constants (paper §3.3 "Handling zoom"). The per-cell
update the controller runs is fleet/step._zoom."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class ZoomConfig:
    zoom_levels: tuple = (1.0, 2.0, 3.0)
    zoom_out_after: float = 3.0      # seconds
    margin: float = 0.7              # cluster must fit in margin * FOV/2
