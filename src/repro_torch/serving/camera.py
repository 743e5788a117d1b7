"""Simulated PTZ camera: rotation physics + capture accounting.

The controller plans in grid cells; the camera tracks continuous angles
and charges rotation time with the Chebyshev metric (pan/tilt motors run
concurrently). Digital zoom is instantaneous (ePTZ; paper §2.2).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.grid import OrientationGrid


@dataclass
class PTZCamera:
    grid: OrientationGrid
    rotation_speed: float = 400.0       # deg/s
    capture_s: float = 0.002            # sensor readout per frame
    angle: np.ndarray = field(default=None)   # (pan, tilt) degrees
    zoom: float = 1.0

    def __post_init__(self):
        if self.angle is None:
            mid = self.grid.cell_index(self.grid.n_pan // 2,
                                       self.grid.n_tilt // 2)
            self.angle = self.grid.centers[mid].copy()

    @property
    def cell(self) -> int:
        d = np.abs(self.grid.centers - self.angle).max(-1)
        return int(np.argmin(d))

    def move_to(self, cell: int, zoom: float = 1.0) -> float:
        """Rotate to a cell center; returns seconds spent."""
        target = self.grid.centers[cell]
        dt = float(np.abs(target - self.angle).max() / self.rotation_speed)
        self.angle = target.copy()
        self.zoom = zoom
        return dt

    def sweep(self, cells: list, zooms: list | None = None) -> float:
        """Visit cells in order; returns total rotation + capture time."""
        zooms = zooms if zooms is not None else [1.0] * len(cells)
        t = 0.0
        for c, z in zip(cells, zooms):
            t += self.move_to(int(c), float(z)) + self.capture_s
        return t
