"""Continual learning with orientation-balanced replay (paper §3.2).

Within each retraining window only the orientations MadEye actually
visited (and deemed send-worthy) produce fresh samples — a severely
imbalanced set (the paper measures 9.3% orientation coverage per 2-minute
window). Training on it as-is overfits recent orientations and
catastrophically forgets ones about to become relevant.

The fix mirrors the paper:
  * neighbors within 3 hops of the latest orientation are PADDED (via the
    historical buffer) up to the sample count of the most popular
    orientation in the window;
  * farther orientations contribute exponentially fewer samples with hop
    distance.

The buffer and the balancing are host-side numpy; `finetune_step` is the
gradient step (frozen backbone, heads-only AdamW,
learn.loop.finetune_update) on tensors on the caller's device.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.grid import OrientationGrid
from repro_torch.learn.loop import finetune_update, init_finetune_state


@dataclass
class ReplayBuffer:
    """Most-recent samples per orientation cell (host side). The
    in-episode counterpart is the per-camera ring
    repro_torch.learn.pairs.PairBuffer, which does not balance:
    balancing needs bookkeeping across retraining windows."""
    n_cells: int
    capacity_per_cell: int = 32
    store: dict = field(default_factory=dict)   # cell -> list of samples

    def add(self, cell: int, sample):
        lst = self.store.setdefault(int(cell), [])
        lst.append(sample)
        if len(lst) > self.capacity_per_cell:
            lst.pop(0)

    def count(self, cell: int) -> int:
        return len(self.store.get(int(cell), []))

    def recent(self, cell: int, k: int) -> list:
        return self.store.get(int(cell), [])[-k:]


def balanced_counts(window_counts: np.ndarray, latest_cell: int,
                    grid: OrientationGrid, *, pad_hops: int = 3,
                    decay: float = 0.5) -> np.ndarray:
    """Target per-orientation sample counts for one retraining round.

    window_counts [n_cells] — fresh samples per cell this window.
    Cells <= pad_hops from latest_cell are padded to the max count;
    farther cells get max_count * decay^(hops - pad_hops).
    """
    max_count = int(window_counts.max()) if window_counts.size else 0
    if max_count == 0:
        return np.zeros_like(window_counts)
    hops = grid.hop_distance[latest_cell]
    return np.where(
        hops <= pad_hops,
        max_count,
        np.maximum(1, np.round(
            max_count * decay ** (hops - pad_hops))).astype(np.int64))


def sample_balanced(buffer: ReplayBuffer, window_counts: np.ndarray,
                    latest_cell: int, grid: OrientationGrid, *,
                    pad_hops: int = 3, decay: float = 0.5,
                    max_total: int = 256) -> list:
    """Draw a balanced batch of samples from the replay buffer (past
    `max_total`, a seeded subset: np.random.RandomState(0))."""
    targets = balanced_counts(window_counts, latest_cell, grid,
                              pad_hops=pad_hops, decay=decay)
    batch = []
    for cell in range(grid.n_cells):
        want = int(targets[cell])
        if want <= 0:
            continue
        batch.extend(buffer.recent(cell, want))
    if len(batch) > max_total:
        idx = np.random.RandomState(0).choice(
            len(batch), max_total, replace=False)
        batch = [batch[i] for i in idx]
    return batch


# the gradient step and its state, under the reference's names
finetune_step = finetune_update
init_finetune = init_finetune_state
