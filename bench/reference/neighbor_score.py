"""Batched candidate-neighbor scoring (paper §3.3): plain PyTorch version
and the controller-native entry `neighbor_scores` with its candidate
mask.

For camera b and cell c the score is the overlap-weighted mean over
shape members o (with boxes) of

    dist(center_c, center_o) / max(dist(center_c, centroid_o), 1e-6)

with weights overlap[c, o] * member_has[b, o]; cells with no weight
score the neutral 1.0.
"""
from __future__ import annotations

import numpy as np
import torch



def geometry_arrays(grid) -> dict:
    """Static per-grid geometry (numpy): d_center/overlap [N, N], the
    8-connected candidate adjacency neighbor8, cell centers cell_x/y."""
    centers = np.asarray(grid.centers, np.float32)
    d_center = np.linalg.norm(
        centers[:, None, :] - centers[None, :, :], axis=-1
    ).astype(np.float32)
    return {
        "d_center": d_center,
        "overlap": np.asarray(grid.overlap_matrix, np.float32),
        "neighbor8": np.asarray(grid.neighbor_mask, bool),
        "cell_x": centers[:, 0].copy(),
        "cell_y": centers[:, 1].copy(),
    }


def neighbor_score_plain(member_has, cent_x, cent_y, d_center, overlap,
                         cell_x, cell_y) -> torch.Tensor:
    """member_has/cent_x/cent_y [B, N] f32; d_center/overlap [N, N];
    cell_x/cell_y [N] -> scores [B, N]."""
    w = overlap[None, :, :] * member_has[:, None, :]          # [B, c, o]
    dx = cell_x[None, :, None] - cent_x[:, None, :]
    dy = cell_y[None, :, None] - cent_y[:, None, :]
    d_box = torch.sqrt(dx * dx + dy * dy)
    ratio = d_center[None, :, :] / torch.clamp(d_box, min=1e-6)
    total = torch.sum(w * ratio, dim=-1)
    total_w = torch.sum(w, dim=-1)
    return torch.where(total_w > 0,
                       total / torch.clamp(total_w, min=1e-9),
                       torch.ones_like(total))


def neighbor_scores(shape_mask, has_boxes, centroids, head, d_center,
                    overlap, cell_x, cell_y, neighbor8):
    """Controller-native layout: shape_mask/has_boxes [B, N] bool,
    centroids [B, N, 2], head [B] int; geometry [N, N] / [N].
    -> (scores [B, N] f32, cand [B, N] bool: lattice neighbors of the
    head not already in the shape)."""
    member_has = (shape_mask & has_boxes).to(torch.float32)
    scores = neighbor_score_plain(member_has, centroids[..., 0],
                                  centroids[..., 1], d_center, overlap,
                                  cell_x, cell_y)
    cand = neighbor8[head] & ~shape_mask
    return scores, cand
