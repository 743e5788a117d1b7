"""The oracle pass of every controller step: plain PyTorch version and
the pieces it shares with the detections path (`hash01`, `SceneObs`,
`_moments`).

For each camera it draws the teacher and approximation-model detection
noise (an integer hash of object id, pair, camera and flicker bucket),
rasterizes the object boxes into every (cell x zoom) window — student
draws as the counted channels, teacher draws as count-only channels —
and reduces them to the observation tables the controller step reads
(`SceneObs`): counts/areas per pair, the box-geometry summaries
(centroid / spread / extent / nbox) and the oracle workload accuracy.
`observe.observe_all_cells` calls `oracle_pass_plain`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench.reference.cell_rasterize import cell_rasterize_plain
from bench.reference.numerics import fma_f32
from bench.reference.scene import kind_mask

MASK32 = 0xFFFFFFFF
_MISS_SALT = 0x4D155
_BASE_SALT = 0xBA5E


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


def oracle_draws(spec, teach, params, state, t: torch.Tensor,
                 cam_salt: torch.Tensor | None = None) -> torch.Tensor:
    """The rasterizer's draws [F, 2P, M]: the student channels (draw
    where the slot is live and the approximation model did not miss it,
    else 2.0, which never detects), then the teacher channels (draw
    where live)."""
    f = state.oid.shape[0]
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
    return torch.cat([draw_student, draw_teacher], 1).contiguous()


def oracle_pass_plain(spec, teach, params, state, t: torch.Tensor,
                      windows: torch.Tensor, *, task_id: tuple,
                      pair_idx: tuple, n_zoom: int = 3,
                      cam_salt: torch.Tensor | None = None) -> SceneObs:
    """One observation pass for the whole fleet at controller frame `t`
    ([F] int, the flicker/miss clock). spec: SceneSpec; teach:
    TeacherArrays; params: SceneFleetParams; state: SceneState. windows
    [N*Z, 4] from `grid_windows`; task_id/pair_idx from WorkloadSpec.
    cam_salt [F] (any stable per-camera int, e.g. a word of the camera's
    key) decorrelates detection/miss noise across cameras."""
    f = state.oid.shape[0]
    p = teach.a0.shape[0]

    # one rasterization pass: teacher draws stack as extra count-only
    # channels [F, 2P, M] (n_moment=P keeps the geometry student-driven)
    cnt2, area2, wcx, wcy, wc2, ext = cell_rasterize_plain(
        state.pos[..., 0].contiguous(), state.pos[..., 1].contiguous(),
        state.size[..., 0].contiguous(), state.size[..., 1].contiguous(),
        oracle_draws(spec, teach, params, state, t, cam_salt),
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
    # the mean over queries as the reference's compiled program takes it:
    # a product by the float32 reciprocal of Q (a division rounds
    # otherwise when Q is not a power of two)
    acc_true = (acc * (1.0 / len(pair_idx))).reshape(f, n, n_zoom)

    return SceneObs(counts=to_nz(cnt), areas=to_nz(area),
                    centroid=centroid, spread=spread, extent=cz(ext),
                    nbox=nbox.to(torch.int64), acc_true=acc_true)
