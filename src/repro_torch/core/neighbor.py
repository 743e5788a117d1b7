"""Neighbor-candidate scoring from bounding-box geometry (paper §3.3).

When the search adds a neighbor for a head orientation H, candidates are
scored by where the objects inside the current shape sit: for candidate c
and shape member o,

    ratio_o(c) = dist(c_center, o_center) / dist(c_center, bbox_centroid_o)

ratios > 1 mean o's boxes sit on the side facing c (likelier to move into
c next timestep). The candidate score is the overlap-weighted sum of
ratios over all shape members with non-zero FOV overlap with c.

All geometry is in scene degrees; the pipeline converts detector outputs
(per-image [0,1] boxes) to scene coordinates before calling in here.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.grid import OrientationGrid


def candidate_cells(grid: OrientationGrid, shape_mask: np.ndarray,
                    h_cell: int) -> np.ndarray:
    """Lattice neighbors of h_cell not already in the shape."""
    nbrs = np.flatnonzero(grid.neighbor_mask[h_cell] & ~shape_mask)
    return nbrs


def score_candidates(grid: OrientationGrid, shape_mask: np.ndarray,
                     h_cell: int, centroids: np.ndarray,
                     has_boxes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Score each candidate neighbor of h_cell.

    centroids [n_cells, 2] — mean bbox center per cell in scene degrees
    (junk where has_boxes is False); has_boxes [n_cells] bool.

    Returns (candidates [K], scores [K]); empty arrays if no candidates.
    """
    cands = candidate_cells(grid, shape_mask, h_cell)
    if cands.size == 0:
        return cands, np.zeros(0)

    scores = np.zeros(cands.size)
    for ci, c in enumerate(cands):
        c_center = grid.centers[c]
        total_w, total = 0.0, 0.0
        for o in np.flatnonzero(shape_mask):
            w = grid.overlap_matrix[c, o]
            if w <= 0.0 or not has_boxes[o]:
                continue
            d_center = np.linalg.norm(c_center - grid.centers[o])
            d_boxes = np.linalg.norm(c_center - centroids[o])
            ratio = d_center / max(d_boxes, 1e-6)
            total += w * ratio
            total_w += w
        # no informative overlap: neutral score so geometry alone decides
        scores[ci] = total / total_w if total_w > 0 else 1.0
    return cands, scores


def best_candidate(grid: OrientationGrid, shape_mask: np.ndarray,
                   h_cell: int, centroids: np.ndarray,
                   has_boxes: np.ndarray) -> int | None:
    cands, scores = score_candidates(grid, shape_mask, h_cell, centroids,
                                     has_boxes)
    if cands.size == 0:
        return None
    return int(cands[np.argmax(scores)])
