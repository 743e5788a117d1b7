"""Batched candidate-neighbor scoring (paper §3.3): plain PyTorch version,
the CUDA kernel's wrapper (csrc/neighbor_score.cu) and the
controller-native entry `neighbor_scores` with its candidate mask.

For camera b and cell c the score is the overlap-weighted mean over
shape members o (with boxes) of

    dist(center_c, center_o) / max(dist(center_c, centroid_o), 1e-6)

with weights overlap[c, o] * member_has[b, o]; cells with no weight
score the neutral 1.0.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _lib

MAX_CELLS = 512     # the kernel's per-camera strips in shared memory


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


def neighbor_score_batch(member_has, cent_x, cent_y, d_center, overlap, cell_x,
                   cell_y) -> torch.Tensor:
    """Same contract as `neighbor_score_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if member_has.device.type == "cpu":
        return neighbor_score_plain(member_has, cent_x, cent_y, d_center,
                                    overlap, cell_x, cell_y)
    args = (member_has, cent_x, cent_y, d_center, overlap, cell_x, cell_y)
    _lib.check_cuda("neighbor_score", *args)
    b, n = member_has.shape
    if cent_x.shape != (b, n) or cent_y.shape != (b, n):
        raise ValueError("neighbor_score: cent_x/cent_y must be [B, N]")
    if d_center.shape != (n, n) or overlap.shape != (n, n):
        raise ValueError("neighbor_score: d_center/overlap must be [N, N]")
    if cell_x.shape != (n,) or cell_y.shape != (n,):
        raise ValueError("neighbor_score: cell_x/cell_y must be [N]")
    if n > MAX_CELLS:
        raise ValueError(f"neighbor_score kernel takes up to {MAX_CELLS} "
                         f"cells, got {n}")
    out = torch.empty((b, n), dtype=torch.float32,
                      device=member_has.device)
    _lib.launch("neighbor_score", member_has.device,
                *(t.data_ptr() for t in args), out.data_ptr(), b, n)
    return out


def neighbor_scores(shape_mask, has_boxes, centroids, head, d_center,
                    overlap, cell_x, cell_y, neighbor8):
    """Controller-native layout: shape_mask/has_boxes [B, N] bool,
    centroids [B, N, 2], head [B] int; geometry [N, N] / [N].
    -> (scores [B, N] f32, cand [B, N] bool: lattice neighbors of the
    head not already in the shape)."""
    member_has = (shape_mask & has_boxes).to(torch.float32)
    scores = neighbor_score_batch(member_has, centroids[..., 0].contiguous(),
                            centroids[..., 1].contiguous(), d_center,
                            overlap, cell_x, cell_y)
    cand = neighbor8[head] & ~shape_mask
    return scores, cand
