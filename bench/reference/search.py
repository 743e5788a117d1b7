"""Contiguous-shape evolution — the head/tail swap algorithm (paper §3.3).

Per timestep the camera explores a flexible shape of contiguous
orientations. The next shape is derived from the current one by swapping
low-potential members (tail T of the label ordering) for neighbors of
high-potential members (head H), guarded by three conditions:

  1. labels[H] / labels[T] > threshold   (threshold grows with every
     additional neighbor added for the same H — "additional uncertainty");
  2. H has lattice neighbors not already in the shape;
  3. removing T keeps the shape 4-connected.

Neighbor choice among H's candidates uses bbox-centroid geometry
(core/neighbor.py). The shape resets to a rectangular seed whenever the
previous timestep found zero objects of interest anywhere in the shape.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from bench.reference import neighbor as nb
from bench.reference.grid import OrientationGrid, removal_keeps_contiguity


def best_rect(grid: OrientationGrid, size: int) -> tuple[int, int]:
    """Most-square (w, h) with w*h <= size on the grid lattice.

    Shared by the numpy seed below and the fleet seed table
    (fleet_state._rect_table) so the two controllers can never
    disagree on the seed geometry."""
    size = int(max(1, min(size, grid.n_cells)))
    best = (1, 1)
    for w in range(1, grid.n_pan + 1):
        for h in range(1, grid.n_tilt + 1):
            if w * h <= size and w * h > best[0] * best[1]:
                best = (w, h)
            elif (w * h == best[0] * best[1]
                  and abs(w - h) < abs(best[0] - best[1])):
                best = (w, h)
    return best


def seed_shape(grid: OrientationGrid, size: int,
               center_cell: int | None = None) -> np.ndarray:
    """Largest coverable rectangle of ~`size` cells around a center.

    Paper: 'MadEye begins with a rectangular seed shape that reflects the
    largest coverable area in the time budget, maximizing early
    exploration.'
    """
    w, h = best_rect(grid, size)
    if center_cell is None:
        center_cell = grid.cell_index(grid.n_pan // 2, grid.n_tilt // 2)
    cp, ct = grid.cell_coords(center_cell)
    p0 = int(np.clip(cp - w // 2, 0, grid.n_pan - w))
    t0 = int(np.clip(ct - h // 2, 0, grid.n_tilt - h))
    mask = np.zeros(grid.n_cells, bool)
    for dp in range(w):
        for dt in range(h):
            mask[grid.cell_index(p0 + dp, t0 + dt)] = True
    return mask


@dataclass
class SearchConfig:
    base_threshold: float = 1.25   # H/T label ratio to justify a swap
    threshold_growth: float = 1.25  # per extra neighbor for the same H
    max_swaps: int = 8             # safety bound per timestep


def evolve_shape(grid: OrientationGrid, shape_mask: np.ndarray,
                 labels: np.ndarray, centroids: np.ndarray,
                 has_boxes: np.ndarray,
                 cfg: SearchConfig = SearchConfig()) -> np.ndarray:
    """One head/tail evolution pass. Returns the next shape mask.

    labels [n_cells] — strictly positive potentials (core/ewma.labels);
    centroids/has_boxes — bbox geometry per cell (core/neighbor).
    """
    mask = shape_mask.copy()
    members = np.flatnonzero(mask)
    if members.size == 0:
        return mask
    if members.size == 1:
        # Degenerate budget (tight fps x slow rotation): the "shape" is a
        # single cell. Drift it toward the neighbor its own boxes are
        # heading for when that neighbor's potential justifies the move;
        # if any cell's EWMA label beats the current cell by a wide margin
        # (e.g. the hotspot moved while we were pinned), jump straight to
        # it — the path planner charges the rotation.
        H = int(members[0])
        best_global = int(np.argmax(labels))
        if (best_global != H
                and labels[best_global] > labels[H] * 2 * cfg.base_threshold):
            mask[H] = False
            mask[best_global] = True
            return mask
        cands, scores = nb.score_candidates(grid, mask, H, centroids,
                                            has_boxes)
        if cands.size == 0:
            return mask
        best = int(cands[np.argmax(scores)])
        moving_away = scores.max() > 1.05      # boxes drifting off-center
        promising = labels[best] > labels[H] * cfg.base_threshold
        if moving_away or promising:
            mask[H] = False
            mask[best] = True
        return mask
    # stable sort: ties break toward the lower cell id on both the numpy
    # and the fleet implementation, keeping them in lockstep
    order = members[np.argsort(-labels[members], kind="stable")]
    h_i, t_i = 0, len(order) - 1
    thresh = cfg.base_threshold
    failed_once = False
    swaps = 0

    while h_i < t_i and swaps < cfg.max_swaps:
        H, T = int(order[h_i]), int(order[t_i])
        if labels[H] / max(labels[T], 1e-9) <= thresh:
            break  # no sufficient disparity left

        cand = nb.best_candidate(grid, mask, H, centroids, has_boxes)
        if cand is None:
            if failed_once:
                break  # paper: end when even one neighbor can't be added
            failed_once = True
            h_i += 1
            thresh = cfg.base_threshold
            continue

        trial = mask.copy()
        trial[cand] = True
        if not removal_keeps_contiguity(trial, T, grid):
            # this tail is structurally load-bearing; try the next one
            t_i -= 1
            continue

        trial[T] = False
        mask = trial
        failed_once = False
        swaps += 1
        t_i -= 1
        thresh *= cfg.threshold_growth  # next neighbor for same H is riskier
    return mask


def resize_shape(grid: OrientationGrid, mask: np.ndarray, labels: np.ndarray,
                 centroids: np.ndarray, has_boxes: np.ndarray,
                 target_size: int) -> np.ndarray:
    """Grow/shrink the shape to the budgeted size while keeping contiguity.

    Growth adds the best-scored neighbor of the highest-label member with
    free neighbors; shrinkage removes the lowest-label member whose removal
    keeps the shape 4-connected.
    """
    mask = mask.copy()
    target_size = int(np.clip(target_size, 1, grid.n_cells))
    # grow
    while mask.sum() < target_size:
        members = np.flatnonzero(mask)
        order = members[np.argsort(-labels[members], kind="stable")]
        added = False
        for H in order:
            cand = nb.best_candidate(grid, mask, int(H), centroids, has_boxes)
            if cand is not None:
                mask[cand] = True
                added = True
                break
        if not added:
            break
    # shrink
    while mask.sum() > target_size:
        members = np.flatnonzero(mask)
        order = members[np.argsort(labels[members], kind="stable")]
        removed = False
        for T in order:
            if removal_keeps_contiguity(mask, int(T), grid):
                mask[T] = False
                removed = True
                break
        if not removed:
            mask[order[0]] = False
    return mask


