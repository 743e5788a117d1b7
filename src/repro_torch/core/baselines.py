"""Baseline orientation-selection strategies (paper §2.2 / §5.3).

All baselines consume the same evaluation substrate: an accuracy table
acc[t, cell] (workload accuracy if the camera sits at `cell` during
timestep t, at that cell's best zoom) plus auxiliary per-cell object
statistics. Oracle schemes read the table directly; online schemes
(Panoptes, tracking, UCB1) only see what they visited — mirroring their
real information models.

Each returns `choices` [T] (cell visited per timestep) or [T, k] when the
scheme ships multiple orientations.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.grid import OrientationGrid


# ---------------------------------------------------------------------------
# Oracle baselines (paper §2.2)
# ---------------------------------------------------------------------------

def one_time_fixed(acc: np.ndarray) -> np.ndarray:
    """Pick the best cell at t=0 and never move."""
    cell = int(np.argmax(acc[0]))
    return np.full(acc.shape[0], cell)


def best_fixed(acc: np.ndarray, k: int = 1) -> np.ndarray:
    """Oracle best fixed orientation(s) over the whole video.

    k > 1 models deploying k fixed cameras (best, 2nd best, ...)."""
    mean = acc.mean(0)
    cells = np.argsort(-mean)[:k]
    return np.tile(cells, (acc.shape[0], 1)) if k > 1 else \
        np.full(acc.shape[0], int(cells[0]))


def best_dynamic(acc: np.ndarray) -> np.ndarray:
    """Oracle best cell per timestep."""
    return np.argmax(acc, axis=1)


# ---------------------------------------------------------------------------
# Panoptes [90] — weighted round-robin with motion triggers
# ---------------------------------------------------------------------------

@dataclass
class PanoptesConfig:
    dwell_base: int = 3          # timesteps per scheduled stop
    motion_thresh: float = 0.5   # motion gradient to trigger a switch
    trigger_dwell: int = 8       # timesteps to linger after a trigger


def panoptes(acc: np.ndarray, motion: np.ndarray,
             interest: np.ndarray | None = None,
             cfg: PanoptesConfig = PanoptesConfig(),
             grid: OrientationGrid | None = None) -> np.ndarray:
    """motion[t, cell] — motion magnitude; interest[cell] — #queries
    interested (None = all equally). Schedule: static round-robin weighted
    by interest x historical motion; interrupts to a neighboring
    orientation when its motion gradient exceeds the threshold."""
    T, N = acc.shape
    interest = np.ones(N) if interest is None else interest
    hist_motion = motion[: max(T // 10, 1)].mean(0) + 1e-6
    weights = interest * hist_motion
    weights = weights / weights.sum()
    dwells = np.maximum(1, np.round(weights * N * cfg.dwell_base)).astype(int)

    # build the static schedule
    sched = []
    for c in np.argsort(-weights):
        sched.extend([int(c)] * int(dwells[c]))
    choices = np.zeros(T, int)
    i = 0
    t = 0
    trigger_until = -1
    trigger_cell = -1
    while t < T:
        if t < trigger_until:
            choices[t] = trigger_cell
            t += 1
            continue
        cell = sched[i % len(sched)]
        choices[t] = cell
        # motion-gradient trigger toward an overlapping orientation
        if grid is not None and t + 1 < T:
            nbrs = np.flatnonzero(grid.neighbor_mask[cell])
            if nbrs.size:
                grads = motion[t, nbrs] - motion[max(t - 1, 0), nbrs]
                j = int(np.argmax(grads))
                if grads[j] > cfg.motion_thresh:
                    trigger_cell = int(nbrs[j])
                    trigger_until = t + cfg.trigger_dwell
        i += 1
        t += 1
    return choices


# ---------------------------------------------------------------------------
# PTZ tracking [85] — follow the largest object, reset to home
# ---------------------------------------------------------------------------

def tracking(largest_size: np.ndarray, largest_cell: np.ndarray,
             home: int, grid: OrientationGrid) -> np.ndarray:
    """largest_size[t] — size of the globally largest object (0 if none);
    largest_cell[t] — the cell containing it. The tracker can only follow
    to lattice-neighbor cells per step (camera physics) and resets to home
    when the object vanishes."""
    T = largest_size.shape[0]
    choices = np.zeros(T, int)
    cur = home
    tracking_obj = False
    for t in range(T):
        if largest_size[t] <= 0:
            cur = home
            tracking_obj = False
        else:
            target = int(largest_cell[t])
            if not tracking_obj:
                # acquire only if visible from current cell (overlap > 0)
                if grid.overlap_matrix[cur, target] > 0 or cur == target:
                    tracking_obj = True
            if tracking_obj and target != cur:
                # move one lattice hop toward the target
                nbrs = np.flatnonzero(grid.neighbor_mask[cur])
                d = grid.hop_distance[nbrs, target]
                cur = int(nbrs[np.argmin(d)])
            elif not tracking_obj:
                cur = home
        choices[t] = cur
    return choices


# ---------------------------------------------------------------------------
# UCB1 multi-armed bandit [97]
# ---------------------------------------------------------------------------

def ucb1(acc: np.ndarray, seed_steps: int = 0, c: float = 2.0,
         rng: np.random.Generator | None = None) -> np.ndarray:
    """Each orientation is a lever; reward = workload accuracy at visit
    time. Seeded with one pull per arm (historical data per the paper)."""
    T, N = acc.shape
    rng = rng or np.random.default_rng(0)
    counts = np.ones(N)
    # seed with historical means (first few frames)
    means = acc[: max(seed_steps, 1)].mean(0).copy()
    choices = np.zeros(T, int)
    for t in range(T):
        ucb = means + np.sqrt(c * np.log(t + N + 1) / counts)
        cell = int(np.argmax(ucb))
        choices[t] = cell
        r = acc[t, cell]
        counts[cell] += 1
        means[cell] += (r - means[cell]) / counts[cell]
    return choices
