"""Orientation grid geometry (paper §2.2 / §5.1).

The default grid mirrors the paper: a 150°x75° scene carved into 30° pan x
15° tilt steps -> 5x5 = 25 rotations, each with zoom in {1, 2, 3}. The
search shape (§3.3) lives on the 25 rotation cells; zoom is a per-cell
controller (core/zoom.py).

Field of view at zoom 1 is (2*pan_step, 2*tilt_step) so direct neighbors
overlap by 50% — matching the paper's observation that neighboring
orientations exhibit substantial content overlap (LPIPS 0.30).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np


@dataclass(frozen=True)
class OrientationGrid:
    pan_extent: float = 150.0       # degrees
    tilt_extent: float = 75.0
    pan_step: float = 30.0
    tilt_step: float = 15.0
    n_zoom: int = 3
    fov_scale: float = 2.0          # FOV at zoom 1 = fov_scale * step

    @property
    def n_pan(self) -> int:
        return int(round(self.pan_extent / self.pan_step))

    @property
    def n_tilt(self) -> int:
        return int(round(self.tilt_extent / self.tilt_step))

    @property
    def n_cells(self) -> int:
        return self.n_pan * self.n_tilt

    @property
    def n_orientations(self) -> int:
        return self.n_cells * self.n_zoom

    # ---- index <-> coordinates ------------------------------------------

    def cell_index(self, pi: int, ti: int) -> int:
        return ti * self.n_pan + pi

    def cell_coords(self, idx: int) -> tuple[int, int]:
        return idx % self.n_pan, idx // self.n_pan

    def cell_center(self, idx: int) -> tuple[float, float]:
        """(pan°, tilt°) of the cell center within the scene."""
        pi, ti = self.cell_coords(idx)
        return ((pi + 0.5) * self.pan_step, (ti + 0.5) * self.tilt_step)

    def fov(self, zoom: float) -> tuple[float, float]:
        return (self.fov_scale * self.pan_step / zoom,
                self.fov_scale * self.tilt_step / zoom)

    # ---- precomputed geometry (cached, numpy) ----------------------------

    @cached_property
    def centers(self) -> np.ndarray:
        """[n_cells, 2] (pan, tilt) centers in degrees."""
        return np.array([self.cell_center(i) for i in range(self.n_cells)])

    @cached_property
    def angular_distance(self) -> np.ndarray:
        """[n_cells, n_cells] max-axis rotation distance in degrees.

        PTZ pan and tilt motors run concurrently, so travel time is
        governed by the larger of the two rotations (Chebyshev metric) —
        this also satisfies the triangle inequality required by the
        MST/TSP heuristic (paper §3.3).
        """
        d = np.abs(self.centers[:, None, :] - self.centers[None, :, :])
        return d.max(-1)

    @cached_property
    def hop_distance(self) -> np.ndarray:
        """[n_cells, n_cells] Chebyshev hop count on the pan-tilt lattice."""
        coords = np.array([self.cell_coords(i) for i in range(self.n_cells)])
        d = np.abs(coords[:, None, :] - coords[None, :, :])
        return d.max(-1)

    @cached_property
    def neighbor_mask(self) -> np.ndarray:
        """[n_cells, n_cells] bool — 8-connected lattice neighbors."""
        h = self.hop_distance
        return (h == 1)

    def overlap_fraction(self, i: int, j: int, zoom: float = 1.0) -> float:
        """Fractional FOV overlap between cells i and j at a given zoom."""
        fw, fh = self.fov(zoom)
        ci, cj = self.centers[i], self.centers[j]
        ow = max(0.0, fw - abs(ci[0] - cj[0]))
        oh = max(0.0, fh - abs(ci[1] - cj[1]))
        return (ow * oh) / (fw * fh)

    @cached_property
    def overlap_matrix(self) -> np.ndarray:
        """[n_cells, n_cells] FOV overlap fraction at zoom 1."""
        n = self.n_cells
        out = np.zeros((n, n))
        for i in range(n):
            for j in range(n):
                out[i, j] = self.overlap_fraction(i, j)
        return out


DEFAULT_GRID = OrientationGrid()


def contiguous(mask: np.ndarray, grid: OrientationGrid) -> bool:
    """Is the set of cells in `mask` 8-connected? (numpy flood fill).

    8-connectivity matches the Chebyshev hop metric: a diagonal move is a
    single concurrent pan+tilt rotation, so diagonal cells are one hop
    apart both physically and for shape contiguity."""
    idx = np.flatnonzero(mask)
    if idx.size <= 1:
        return True
    adj = grid.neighbor_mask
    seen = np.zeros(grid.n_cells, bool)
    stack = [int(idx[0])]
    seen[idx[0]] = True
    while stack:
        i = stack.pop()
        for j in np.flatnonzero(adj[i] & mask & ~seen):
            seen[j] = True
            stack.append(int(j))
    return bool(seen[mask].all())


def removal_keeps_contiguity(mask: np.ndarray, cell: int,
                             grid: OrientationGrid) -> bool:
    m = mask.copy()
    m[cell] = False
    return contiguous(m, grid)
