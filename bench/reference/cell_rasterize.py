"""Boxes -> (cell x zoom) window rasterization: plain PyTorch version and
the static windows.

For each object m and window c (a flattened cell x zoom orientation):
clip the box to the window and keep it when clipped area / box area >=
min_visible; its apparent size max(nw, nh) drives per-channel detection
through the saturating teacher response clip((apparent - a0) / (a1 -
a0), 0, 1), beaten by draw[p, m] (2.0 never detects). Detected boxes
accumulate counts, normalized areas and, over the first `n_moment`
channels, the multiplicity-weighted center moments and max clipped side
the zoom controller's centroid/spread/extent statistics come from.
"""
from __future__ import annotations

import numpy as np
import torch



def window_arrays(grid, zoom_levels=(1.0, 2.0, 3.0)) -> np.ndarray:
    """[N * Z, 4] static FOV windows (x0, y0, fw, fh), cell-major —
    orientation c_flat = cell * Z + zoom_idx."""
    rows = []
    for cell in range(grid.n_cells):
        cx, cy = grid.centers[cell]
        for z in zoom_levels:
            fw, fh = grid.fov(z)
            rows.append((cx - fw / 2, cy - fh / 2, fw, fh))
    return np.asarray(rows, np.float32)


def window_geometry(ox, oy, ow, oh, draw, a0, a1, windows, *,
                    min_visible: float = 0.25):
    """The per-(object, window) terms the sums reduce: detections detf
    [B, P, M, C] (float 0/1), normalized clipped area a_norm, clipped
    center ccx/ccy and clipped side, each [B, M, C]."""
    x0 = windows[:, 0][None, None, :]           # [1, 1, C]
    y0 = windows[:, 1][None, None, :]
    fw = windows[:, 2][None, None, :]
    fh = windows[:, 3][None, None, :]
    ox0 = (ox - ow / 2)[..., None]              # [B, M, 1]
    ox1 = (ox + ow / 2)[..., None]
    oy0 = (oy - oh / 2)[..., None]
    oy1 = (oy + oh / 2)[..., None]

    ix0 = torch.maximum(ox0, x0)
    ix1 = torch.minimum(ox1, x0 + fw)
    iy0 = torch.maximum(oy0, y0)
    iy1 = torch.minimum(oy1, y0 + fh)
    iw = torch.clamp(ix1 - ix0, min=0.0)        # [B, M, C]
    ih = torch.clamp(iy1 - iy0, min=0.0)
    vis = (iw * ih) / torch.clamp((ow * oh)[..., None], min=1e-9)
    visible = vis >= min_visible

    nw = iw / fw
    nh = ih / fh
    apparent = torch.maximum(nw, nh)
    a_norm = nw * nh
    ccx = (ix0 + ix1) / 2
    ccy = (iy0 + iy1) / 2

    span = torch.clamp(a1 - a0, min=1e-6)[None, :, None, None]
    x = torch.clamp((apparent[:, None] - a0[None, :, None, None]) / span,
                    0.0, 1.0)                   # [B, P, M, C]
    detf = ((draw[..., None] < x) & visible[:, None]).to(torch.float32)
    return detf, a_norm, ccx, ccy, torch.maximum(iw, ih)


def cell_rasterize_plain(ox, oy, ow, oh, draw, a0, a1, windows, *,
                         min_visible: float = 0.25,
                         n_moment: int | None = None):
    """ox/oy/ow/oh [B, M]; draw [B, P, M]; a0/a1 [P]; windows [C, 4].
    -> (cnt [B, P, C], area [B, P, C], wcx, wcy, wc2, ext [B, C])."""
    detf, a_norm, ccx, ccy, side = window_geometry(
        ox, oy, ow, oh, draw, a0, a1, windows, min_visible=min_visible)
    cnt = torch.sum(detf, dim=2)                # [B, P, C]
    area = torch.sum(detf * a_norm[:, None], dim=2)
    if n_moment is None:
        n_moment = detf.shape[1]
    mult = torch.sum(detf[:, :n_moment], dim=1)  # [B, M, C]
    wcx = torch.sum(mult * ccx, dim=1)           # [B, C]
    wcy = torch.sum(mult * ccy, dim=1)
    wc2 = torch.sum(mult * (ccx * ccx + ccy * ccy), dim=1)
    ext = torch.amax(torch.where(mult > 0, side, torch.zeros_like(side)),
                     dim=1)
    return cnt, area, wcx, wcy, wc2, ext
