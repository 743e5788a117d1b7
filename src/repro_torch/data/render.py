"""Orientation rendering: scene snapshot -> ground-truth boxes / images.

`gt_boxes` is the exact oracle (what a perfect detector would see at an
orientation + zoom). `render_image` rasterizes a simple but structured
image (class-colored blobs on textured background) for the NN-path tests
and continual-distillation training; it replaces the paper's
equirectangular-to-rectilinear converter — our simulator works directly in
scene degrees so the projection is an axis-aligned crop.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.grid import OrientationGrid
from repro_torch.data.scene import CAR, PERSON


def fov_window(grid: OrientationGrid, cell: int, zoom: float):
    """(pan_lo, tilt_lo, fov_w, fov_h) of the cell's view at `zoom`."""
    cx, cy = grid.centers[cell]
    fw, fh = grid.fov(zoom)
    return cx - fw / 2, cy - fh / 2, fw, fh


def gt_boxes(snapshot: dict, grid: OrientationGrid, cell: int, zoom: float,
             min_visible: float = 0.25):
    """Objects visible from (cell, zoom) -> normalized image-space boxes.

    Returns dict with boxes [K,4] cxcywh in [0,1], classes [K], ids [K],
    apparent [K] (apparent size = max box side, the detectability driver).
    Objects are kept if >= `min_visible` of their area is inside the FOV.
    """
    x0, y0, fw, fh = fov_window(grid, cell, zoom)
    pos, size = snapshot["pos"], snapshot["size"]

    # object extent in scene degrees
    ox0 = pos[:, 0] - size[:, 0] / 2
    ox1 = pos[:, 0] + size[:, 0] / 2
    oy0 = pos[:, 1] - size[:, 1] / 2
    oy1 = pos[:, 1] + size[:, 1] / 2

    ix0 = np.maximum(ox0, x0)
    ix1 = np.minimum(ox1, x0 + fw)
    iy0 = np.maximum(oy0, y0)
    iy1 = np.minimum(oy1, y0 + fh)
    inter = np.maximum(ix1 - ix0, 0) * np.maximum(iy1 - iy0, 0)
    area = (ox1 - ox0) * (oy1 - oy0)
    vis = inter / np.maximum(area, 1e-9)
    keep = vis >= min_visible

    # clip to FOV and normalize
    bx0 = (ix0[keep] - x0) / fw
    bx1 = (ix1[keep] - x0) / fw
    by0 = (iy0[keep] - y0) / fh
    by1 = (iy1[keep] - y0) / fh
    boxes = np.stack([(bx0 + bx1) / 2, (by0 + by1) / 2,
                      bx1 - bx0, by1 - by0], axis=-1)
    apparent = np.maximum(boxes[:, 2], boxes[:, 3]) if keep.any() else \
        np.zeros(0)
    return {
        "boxes": boxes.reshape(-1, 4),
        "classes": snapshot["kind"][keep],
        "ids": snapshot["oid"][keep],
        "apparent": apparent,
        "visibility": vis[keep],
    }


def boxes_to_scene(boxes: np.ndarray, grid: OrientationGrid, cell: int,
                   zoom: float):
    """Normalized image boxes -> (centers [K,2], sizes [K,2]) in degrees."""
    x0, y0, fw, fh = fov_window(grid, cell, zoom)
    centers = np.stack([x0 + boxes[:, 0] * fw, y0 + boxes[:, 1] * fh], -1)
    sizes = np.stack([boxes[:, 2] * fw, boxes[:, 3] * fh], -1)
    return centers, sizes


_CLASS_COLOR = {PERSON: np.array([0.9, 0.3, 0.2]),
                CAR: np.array([0.2, 0.4, 0.9])}


def render_image(snapshot: dict, grid: OrientationGrid, cell: int,
                 zoom: float, res: int = 64, noise: float = 0.05,
                 rng: np.random.Generator | None = None) -> np.ndarray:
    """Rasterize the orientation view to [res, res, 3] float32 in [0,1]."""
    rng = rng or np.random.default_rng(snapshot["t"])
    gt = gt_boxes(snapshot, grid, cell, zoom)
    # textured background: horizontal gradient + low-freq noise
    yy, xx = np.mgrid[0:res, 0:res] / res
    img = np.stack([0.35 + 0.15 * yy, 0.4 + 0.1 * xx,
                    0.35 + 0.05 * (xx + yy)], axis=-1)
    img += noise * rng.standard_normal((res, res, 3))

    for box, cls, oid in zip(gt["boxes"], gt["classes"], gt["ids"]):
        cx, cy, w, h = box
        px0 = int(np.clip((cx - w / 2) * res, 0, res - 1))
        px1 = int(np.clip((cx + w / 2) * res + 1, 1, res))
        py0 = int(np.clip((cy - h / 2) * res, 0, res - 1))
        py1 = int(np.clip((cy + h / 2) * res + 1, 1, res))
        shade = 0.7 + 0.3 * ((oid * 2654435761) % 97) / 97.0
        img[py0:py1, px0:px1] = _CLASS_COLOR[int(cls)] * shade
    return np.clip(img, 0.0, 1.0).astype(np.float32)
