"""Scene state -> per-(cell, zoom, pair) observation tables, on the device.

`observe_all_cells` is the oracle pass of every controller step: for
each camera the approximation-model counts/areas per (cell, zoom, pair),
the box-geometry summaries the zoom controller reads (centroid / spread
/ extent / nbox) and the oracle workload accuracy that grades the
camera's choice. It is one launch of the `oracle_pass` kernel on the
card (kernels/oracle_pass: the hash draws, the rasterization and the
reductions together); CPU tensors run its plain version.

Teacher model: detection probability is a saturating ramp of apparent
size with per-(model, class) quirked thresholds and a base + bucket
flicker mix; the uniform draw is an integer hash of (object id, pair,
bucket), so detections flicker on the paper's timescale and are exactly
reproducible. The approximation model misses an extra per-(object,
step) fraction (`miss_rate`).

`detections_obs` turns the detector's outputs into the same tables, so
the controller step consumes either.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.cell_rasterize.ops import window_arrays
from repro_torch.kernels.oracle_pass.ops import (  # noqa: F401
    SceneObs,
    _moments,
    hash01,
    oracle_pass,
)
from repro_torch.scene.scene import (
    OBJ_IDS,
    SceneFleetParams,
    SceneSpec,
    SceneState,
)
from repro_torch.serving.teachers import TEACHERS


class TeacherArrays(NamedTuple):
    """Per-pair teacher response constants for one workload."""
    a0: torch.Tensor        # [P] quirked apparent-size floor
    a1: torch.Tensor        # [P] quirked saturation size
    pmax: torch.Tensor      # [P] plateau detection probability
    flicker: torch.Tensor   # [P] bucket-hash mix weight
    cls: torch.Tensor       # [P] object class (PERSON/CAR)
    salt: torch.Tensor      # [P] stable per-pair hash salt (uint32 value)


def _fnv_host(*keys) -> int:
    """Stable 32-bit FNV-1a of the stringified keys (host side)."""
    h = 2166136261
    for b in "|".join(map(str, keys)).encode():
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def teacher_arrays(pairs, device=None) -> TeacherArrays:
    """pairs: WorkloadSpec.pairs — ((model, obj), ...) in table order."""
    a0, a1, pmax, flick, cls, salt = [], [], [], [], [], []
    for model, obj in pairs:
        prof = TEACHERS[model]
        c = OBJ_IDS[obj]
        q = prof.class_quirk(c)
        a0.append(prof.a_min * q)
        a1.append(prof.a_sat * q)
        pmax.append(prof.p_max)
        flick.append(prof.flicker)
        cls.append(c)
        salt.append(_fnv_host(model, obj))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return TeacherArrays(
        a0=f32(a0), a1=f32(a1), pmax=f32(pmax), flicker=f32(flick),
        cls=torch.as_tensor(cls, dtype=torch.int64, device=device),
        salt=torch.as_tensor(salt, dtype=torch.int64, device=device))


def grid_windows(grid, zoom_levels=(1.0, 2.0, 3.0),
                 device=None) -> torch.Tensor:
    """The flattened (cell x zoom) FOV windows [N * Z, 4]."""
    return torch.as_tensor(window_arrays(grid, zoom_levels), device=device)


def detections_obs(dets, windows: torch.Tensor, pair_cls: torch.Tensor,
                   thresh: torch.Tensor, geo_thresh: torch.Tensor,
                   acc_true: torch.Tensor, *, n_zoom: int = 3) -> SceneObs:
    """Detector outputs -> the observation tables the oracle pass
    produces, so `fleet_step` consumes either interchangeably.

    dets: Detections with leaves [F, C, K, ...] — one row per (camera,
    flattened cell x zoom window); windows [C, 4]; pair_cls [P] object
    class per workload pair; thresh [P] per-pair score threshold (a
    detection counts for pair p when its score clears thresh[p] AND its
    argmax class is pair p's object); geo_thresh [] score floor for the
    zoom-geometry statistics. acc_true [F, N, Z] rides through.
    Geometry converts normalized boxes to scene degrees through each
    window's FOV transform."""
    f, c, k = dets.scores.shape
    n = c // n_zoom
    x0 = windows[:, 0][None, :, None]           # [1, C, 1]
    y0 = windows[:, 1][None, :, None]
    fw = windows[:, 2][None, :, None]
    fh = windows[:, 3][None, :, None]
    deg_x = x0 + dets.boxes[..., 0] * fw        # [F, C, K]
    deg_y = y0 + dets.boxes[..., 1] * fh
    w_img, h_img = dets.boxes[..., 2], dets.boxes[..., 3]

    cls_id = torch.argmax(dets.class_probs, dim=-1)         # [F, C, K]
    keep_p = ((dets.scores[:, :, None, :] >= thresh[None, None, :, None])
              & (cls_id[:, :, None, :]
                 == pair_cls[None, None, :, None]))         # [F, C, P, K]
    kf = keep_p.to(torch.float32)
    counts = kf.sum(-1)                                     # [F, C, P]
    areas = (kf * (w_img * h_img)[:, :, None, :]).sum(-1)

    geo = (dets.scores >= geo_thresh).to(torch.float32)     # [F, C, K]
    nbox = geo.sum(-1)                                      # [F, C]
    centroid, spread = _moments(
        nbox, (geo * deg_x).sum(-1), (geo * deg_y).sum(-1),
        (geo * (deg_x * deg_x + deg_y * deg_y)).sum(-1))
    side = torch.maximum(w_img * fw, h_img * fh)
    extent = torch.where(geo > 0, side, 0.0).amax(-1)

    def to_nz(x):           # [F, C, ...] -> [F, N, Z, ...]
        return x.reshape((f, n, n_zoom) + x.shape[2:])

    return SceneObs(counts=to_nz(counts), areas=to_nz(areas),
                    centroid=to_nz(centroid), spread=to_nz(spread),
                    extent=to_nz(extent),
                    nbox=to_nz(nbox).to(torch.int64), acc_true=acc_true)


def observe_all_cells(spec: SceneSpec, teach: TeacherArrays,
                      params: SceneFleetParams, state: SceneState,
                      t: torch.Tensor, windows: torch.Tensor, *,
                      task_id: tuple, pair_idx: tuple, n_zoom: int = 3,
                      cam_salt: torch.Tensor | None = None) -> SceneObs:
    """One observation pass for the whole fleet at controller frame `t`
    ([F] int, the flicker/miss clock). windows [N*Z, 4] from
    `grid_windows`; task_id/pair_idx from WorkloadSpec. cam_salt [F]
    (any stable per-camera int, e.g. a word of the camera's key)
    decorrelates detection/miss noise across cameras."""
    return oracle_pass(spec, teach, params, state, t, windows,
                       task_id=task_id, pair_idx=pair_idx, n_zoom=n_zoom,
                       cam_salt=cam_salt)
