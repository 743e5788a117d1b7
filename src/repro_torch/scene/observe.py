"""Scene state -> per-(cell, zoom, pair) observation tables, on the device.

`observe_all_cells` is the oracle pass of every controller step: for
each camera the approximation-model counts/areas per (cell, zoom, pair),
the box-geometry summaries the zoom controller reads (centroid / spread
/ extent / nbox) and the oracle workload accuracy that grades the
camera's choice. It goes through the `cell_rasterize` kernel.

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

from repro_torch.numerics import fma_f32
from repro_torch.kernels.cell_rasterize.ops import (
    cell_rasterize,
    window_arrays,
)
from repro_torch.scene.scene import (
    OBJ_IDS,
    SceneFleetParams,
    SceneSpec,
    SceneState,
    kind_mask,
)
from repro_torch.scene.teachers import TEACHERS

MASK32 = 0xFFFFFFFF
_MISS_SALT = 0x4D155
_BASE_SALT = 0xBA5E


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


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of h * c for uint32 values held in int64, without an
    int64 overflow: the constant is applied in two 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def hash01(*ints) -> torch.Tensor:
    """Stable uniform [0, 1) from broadcastable integer tensors (uint32
    semantics in int64): per-key mixing with an xxhash-style avalanche,
    shared by the flicker draws and the approx-miss draws."""
    h = None
    for x in ints:
        x = torch.as_tensor(x, dtype=torch.int64) & MASK32
        h = (0x811C9DC5 ^ x) if h is None else h ^ x
        h = _mul32(h, 0x9E3779B1)
        h = h ^ (h >> 15)
        h = _mul32(h, 0x85EBCA77)
        h = h ^ (h >> 13)
    return h.to(torch.float32) * (2.0 ** -32)


class SceneObs(NamedTuple):
    """Per-camera observation tables; leaves lead with [F, N, Z]."""
    counts: torch.Tensor    # [F, N, Z, P]
    areas: torch.Tensor     # [F, N, Z, P]
    centroid: torch.Tensor  # [F, N, Z, 2]
    spread: torch.Tensor    # [F, N, Z]
    extent: torch.Tensor    # [F, N, Z]
    nbox: torch.Tensor      # [F, N, Z] int64
    acc_true: torch.Tensor  # [F, N, Z]


def grid_windows(grid, zoom_levels=(1.0, 2.0, 3.0),
                 device=None) -> torch.Tensor:
    """The flattened (cell x zoom) FOV windows [N * Z, 4]."""
    return torch.as_tensor(window_arrays(grid, zoom_levels), device=device)


def _moments(nbox, sx, sy, s2):
    """Box count + summed centers -> (centroid [..., 2], RMS spread)."""
    nb = torch.clamp(nbox, min=1e-9)
    cx = sx / nb
    cy = sy / nb
    has = nbox > 0
    centroid = torch.where(has[..., None], torch.stack([cx, cy], -1), 0.0)
    # E[c^2] - cx^2 - cy^2 cancels for tight clusters, so its round-off
    # shows in the spread: two fused multiply-adds round it as the
    # reference's compiled program does
    var = fma_f32(-cy, cy, fma_f32(-cx, cx, s2 / nb))
    spread = torch.where(has, torch.sqrt(torch.clamp(var, min=0.0)), 0.0)
    return centroid, spread


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
    f, m = state.oid.shape
    p = teach.a0.shape[0]
    dev = state.oid.device
    kinds = torch.as_tensor(kind_mask(spec), device=dev)
    cls_match = teach.cls[:, None] == kinds[None, :]        # [P, M]

    if cam_salt is None:
        cam_salt = torch.zeros(f, dtype=torch.int64, device=dev)
    cam = cam_salt[:, None, None]                           # [F, 1, 1]
    oid = state.oid[:, None, :]                             # [F, 1, M]
    salt = teach.salt[None, :, None]                        # [1, P, 1]
    bucket = (t // spec.flicker_bucket)[:, None, None]      # [F, 1, 1]
    flick = teach.flicker[None, :, None]
    draw = ((1.0 - flick) * hash01(oid, salt, cam, _BASE_SALT)
            + flick * hash01(oid, salt, cam, bucket))
    # normalize by the plateau so the rasterizer's ramp test draw < resp
    # reproduces draw < p_max * resp
    draw = draw / torch.clamp(teach.pmax[None, :, None], min=1e-6)
    live = params.enabled[:, None, :] & cls_match[None]     # [F, P, M]
    keep = hash01(state.oid, t[:, None], cam_salt[:, None],
                  _MISS_SALT) >= spec.miss_rate             # [F, M]
    draw_student = torch.where(live & keep[:, None, :], draw, 2.0)
    draw_teacher = torch.where(live, draw, 2.0)

    # one rasterization pass: teacher draws stack as extra count-only
    # channels [F, 2P, M] (n_moment=P keeps the geometry student-driven)
    cnt2, area2, wcx, wcy, wc2, ext = cell_rasterize(
        state.pos[..., 0].contiguous(), state.pos[..., 1].contiguous(),
        state.size[..., 0].contiguous(), state.size[..., 1].contiguous(),
        torch.cat([draw_student, draw_teacher], 1).contiguous(),
        teach.a0.repeat(2), teach.a1.repeat(2), windows.contiguous(),
        min_visible=spec.min_visible, n_moment=p)
    cnt, area = cnt2[:, :p], area2[:, :p]
    cnt_t = cnt2[:, p:]

    n = windows.shape[0] // n_zoom

    def to_nz(x):           # [F, P, C] -> [F, N, Z, P]
        return x.reshape(f, p, n, n_zoom).permute(0, 2, 3, 1)

    nbox = cnt.sum(1).reshape(f, n, n_zoom)

    def cz(x):
        return x.reshape(f, n, n_zoom)

    centroid, spread = _moments(nbox, cz(wcx), cz(wcy), cz(wc2))

    # oracle workload accuracy from teacher counts (relative per step)
    acc = None
    for q in range(len(pair_idx)):
        c_q = cnt_t[:, pair_idx[q], :]                      # [F, C]
        mx = c_q.max(-1, keepdim=True).values
        if task_id[q] == 0:       # binary: correct "no" when scene empty
            a = torch.where(mx > 0, (c_q > 0).to(torch.float32), 1.0)
        else:                     # count / detect / agg_count
            a = torch.where(mx > 0, c_q / torch.clamp(mx, min=1e-9), 1.0)
        acc = a if acc is None else acc + a
    acc_true = (acc / len(pair_idx)).reshape(f, n, n_zoom)

    return SceneObs(counts=to_nz(cnt), areas=to_nz(area),
                    centroid=centroid, spread=spread, extent=cz(ext),
                    nbox=nbox.to(torch.int64), acc_true=acc_true)
