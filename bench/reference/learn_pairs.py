"""Training-pair harvesting: sent crops -> per-camera distillation pairs.

The paper's constraint (§3.4) is that distillation runs "with only
camera resources": the teacher only ever grades frames the budget
actually shipped. This module keeps to that exactly —

  * `select_sent_windows` picks up to `harvest` of this step's SENT
    windows (the chosen orientation first, then descending predicted
    accuracy), so training pairs only come from crops the backend saw;
  * `teacher_window_targets` gives the teacher's detections in those
    windows as static-shape tensors, by the oracle pass's geometry and
    teacher-draw rule (clip -> visibility -> apparent-size ramp ->
    hashed flicker draw), in window-normalized cxcywh;
  * `PairBuffer` is the per-camera ring the pairs land in; the student
    payload (staged post-neck features or patch tokens) is gathered from
    the SAME [F, K] forward the ranking used, so harvesting costs no
    extra render or backbone pass.

Every function is row-wise over the fleet axis (no cross-camera
reduction, no shared randomness). Top-k picks are a stable descending
sort (ties toward the lower index, as the reference's `lax.top_k`), and
ring writes are `torch.where` selections, so nothing depends on the
order a device applies repeated writes in and nothing reads back to the
host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench.reference.oracle_pass import _BASE_SALT, hash01
from bench.reference.observe import TeacherArrays
from bench.reference.scene import (
    CAR,
    PERSON,
    SceneFleetParams,
    SceneSpec,
    SceneState,
)


class PairBuffer(NamedTuple):
    """Per-camera ring of distillation pairs. `x` is the student payload
    — post-neck features [F, B, g, g, Fd] in head-only mode, patch
    tokens [F, B, P, D] in full-param mode. `weight` is 1.0 for filled
    slots, 0.0 for empty — the loss weighs by it."""
    x: torch.Tensor          # [F, B, ...] student payload
    boxes: torch.Tensor      # [F, B, mb, 4] teacher boxes (cxcywh, window)
    classes: torch.Tensor    # [F, B, mb] int64 teacher classes
    valid: torch.Tensor      # [F, B, mb] bool per-box validity
    weight: torch.Tensor     # [F, B] float32 slot fill weight
    ptr: torch.Tensor        # [F] int64 next write position


def init_pair_buffer(n_cameras: int, buffer: int, payload_shape: tuple,
                     max_boxes: int, device=None) -> PairBuffer:
    f, b = n_cameras, buffer
    return PairBuffer(
        x=torch.zeros((f, b) + tuple(payload_shape), device=device),
        boxes=torch.zeros((f, b, max_boxes, 4), device=device),
        classes=torch.zeros((f, b, max_boxes), dtype=torch.int64,
                            device=device),
        valid=torch.zeros((f, b, max_boxes), dtype=torch.bool,
                          device=device),
        weight=torch.zeros((f, b), device=device),
        ptr=torch.zeros((f,), dtype=torch.int64, device=device))


def _top_k(score: torch.Tensor, k: int):
    """The k largest along the last axis, ties toward the lower index."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_sent_windows(out, n_zoom: int, harvest: int):
    """FleetStepOut -> the flattened window ids (cell * Z + zoom) worth
    harvesting this step.

    Only SENT cells qualify. Priority: the chosen orientation first (it
    is always sent), then descending predicted accuracy, ties toward the
    lower cell. Returns (widx [F, H] int64, ok [F, H] bool) — ok=False
    rows are padding when fewer than `harvest` cells were sent."""
    score = torch.where(out.sent, out.pred_acc, -torch.inf)
    chosen = out.chosen[:, None]
    bonus = torch.where(torch.gather(out.sent, 1, chosen), 10.0, 0.0)
    score = score + torch.zeros_like(score).scatter(1, chosen, bonus)
    vals, cells = _top_k(score, harvest)                    # [F, H]
    ok = torch.isfinite(vals)
    safe_cells = torch.where(ok, cells, 0)
    zooms = torch.gather(out.zooms, 1, safe_cells)
    return safe_cells * n_zoom + zooms, ok


def teacher_window_targets(spec: SceneSpec, teach: TeacherArrays,
                           params: SceneFleetParams, sc: SceneState,
                           t: torch.Tensor, sel_windows: torch.Tensor,
                           max_boxes: int, cam_salt: torch.Tensor):
    """Teacher detections for the harvested windows, as static targets.

    sel_windows [F, H, 4] (x0, y0, fw, fh) scene-degree FOVs; t [F] the
    flicker clock frame (the SAME frame the observation pass used);
    cam_salt [F] the per-camera noise salt (state.rng[:, 0]).

    An object is a teacher detection in a window when it is >=
    min_visible there and its hashed flicker draw clears the
    apparent-size response ramp for ANY workload pair of its class — the
    rule the oracle pass counts for acc_true. Boxes come back
    window-normalized cxcywh (the clipped extent), the `max_boxes`
    largest first; past the scene's object slots the rows are padding
    (valid False, zeros). Returns (boxes [F, H, mb, 4], classes [F, H,
    mb] int64, valid [F, H, mb] bool)."""
    dev = sc.oid.device
    # kind_mask's layout, made on the device (no host-to-device copy)
    kinds = torch.where(torch.arange(spec.max_objects, device=dev)
                        < spec.max_people, PERSON, CAR)      # [M]
    cls_match = teach.cls[:, None] == kinds[None, :]        # [P, M]

    # teacher draw (the oracle pass's rule: base/bucket flicker mix of
    # the hash, normalized by the plateau; disabled slots never fire)
    cam = cam_salt[:, None, None]                           # [F, 1, 1]
    oid = sc.oid[:, None, :]                                # [F, 1, M]
    salt = teach.salt[None, :, None]                        # [1, P, 1]
    bucket = (t // spec.flicker_bucket)[:, None, None]      # [F, 1, 1]
    flick = teach.flicker[None, :, None]
    draw = ((1.0 - flick) * hash01(oid, salt, cam, _BASE_SALT)
            + flick * hash01(oid, salt, cam, bucket))
    draw = draw / torch.clamp(teach.pmax[None, :, None], min=1e-6)
    live = params.enabled[:, None, :] & cls_match[None]     # [F, P, M]
    draw_t = torch.where(live, draw, 2.0)

    # window clipping + visibility (the rasterizer's geometry)
    x0 = sel_windows[..., 0][:, None, :]                    # [F, 1, H]
    y0 = sel_windows[..., 1][:, None, :]
    fw = sel_windows[..., 2][:, None, :]
    fh = sel_windows[..., 3][:, None, :]
    ox, oy = sc.pos[..., 0], sc.pos[..., 1]                 # [F, M]
    ow, oh = sc.size[..., 0], sc.size[..., 1]
    ix0 = torch.maximum((ox - ow / 2)[..., None], x0)       # [F, M, H]
    ix1 = torch.minimum((ox + ow / 2)[..., None], x0 + fw)
    iy0 = torch.maximum((oy - oh / 2)[..., None], y0)
    iy1 = torch.minimum((oy + oh / 2)[..., None], y0 + fh)
    iw = torch.clamp(ix1 - ix0, min=0.0)
    ih = torch.clamp(iy1 - iy0, min=0.0)
    vis = (iw * ih) / torch.clamp((ow * oh)[..., None], min=1e-9)
    visible = vis >= spec.min_visible

    nw, nh = iw / fw, ih / fh
    apparent = torch.maximum(nw, nh)
    resp = torch.clamp(
        (apparent[:, None] - teach.a0[None, :, None, None])
        / torch.clamp((teach.a1 - teach.a0)[None, :, None, None],
                      min=1e-6), 0.0, 1.0)                  # [F, P, M, H]
    det = (draw_t[..., None] < resp) & visible[:, None]
    det_any = det.any(1)                                    # [F, M, H]

    # window-normalized cxcywh of the clipped extent
    bcx = ((ix0 + ix1) / 2 - x0) / fw
    bcy = ((iy0 + iy1) / 2 - y0) / fh
    boxes_all = torch.stack([bcx, bcy, nw, nh], -1).transpose(1, 2)

    score = torch.where(det_any, nw * nh, -1.0).transpose(1, 2)
    k = min(max_boxes, score.shape[-1])
    vals, midx = _top_k(score, k)                           # [F, H, k]
    boxes = torch.gather(boxes_all, 2,
                         midx[..., None].expand(-1, -1, -1, 4))
    classes = kinds[midx]
    bvalid = vals > 0.0
    pad = max_boxes - k
    if pad:
        boxes = torch.nn.functional.pad(boxes, (0, 0, 0, pad))
        classes = torch.nn.functional.pad(classes, (0, pad))
        bvalid = torch.nn.functional.pad(bvalid, (0, pad))
    return boxes, classes, bvalid


def harvest_into_buffer(buf: PairBuffer, staged: torch.Tensor,
                        staged_widx: torch.Tensor, sel_widx: torch.Tensor,
                        sel_ok: torch.Tensor, boxes: torch.Tensor,
                        classes: torch.Tensor, bvalid: torch.Tensor
                        ) -> PairBuffer:
    """Ring-write this step's harvested pairs into a new PairBuffer.

    staged [F, K, ...] is the inference pass's student payload;
    staged_widx [F, K] the window ids it covers. Selected windows that
    are not in the staged set and padding rows (sel_ok=False) are
    dropped, so real entries are never clobbered by invalid ones. Each
    ring slot takes the one found row aimed at it (found rows of a
    camera aim at distinct slots, harvest <= buffer), else keeps its
    old value. Row-wise per camera."""
    f, b = buf.weight.shape
    k = staged_widx.shape[1]
    eq = staged_widx[:, :, None] == sel_widx[:, None, :]    # [F, K, H]
    # the first staged position holding each selected window
    kk = torch.arange(k, device=eq.device)[None, :, None]
    pos = torch.where(eq, kk, k).amin(1).clamp(max=k - 1)   # [F, H]
    found = eq.any(1) & sel_ok
    nf = found.long()
    offs = torch.cumsum(nf, 1) - nf
    slot = (buf.ptr[:, None] + offs) % b                    # [F, H]

    # per ring slot: the harvested row written there, if any
    hit = found[:, :, None] & (slot[:, :, None]
                               == torch.arange(b, device=eq.device))
    h = hit.shape[1]
    hh = torch.arange(h, device=eq.device)[None, :, None]
    row = torch.where(hit, hh, h).amin(1).clamp(max=h - 1)  # [F, B]
    wrote = hit.any(1)                                      # [F, B]

    def put(old, new):
        """new [F, H, ...] rows into old [F, B, ...] where written."""
        idx = row.reshape(row.shape + (1,) * (new.ndim - 2))
        picked = torch.gather(new, 1, idx.expand((f, b) + new.shape[2:]))
        w = wrote.reshape(wrote.shape + (1,) * (old.ndim - 2))
        return torch.where(w, picked, old)

    payload = torch.gather(staged, 1, pos.reshape(
        pos.shape + (1,) * (staged.ndim - 2)).expand(
        pos.shape + staged.shape[2:]))                      # [F, H, ...]
    return PairBuffer(
        x=put(buf.x, payload.to(buf.x.dtype)),
        boxes=put(buf.boxes, boxes.to(buf.boxes.dtype)),
        classes=put(buf.classes, classes.to(buf.classes.dtype)),
        valid=put(buf.valid, bvalid),
        weight=torch.where(wrote, 1.0, buf.weight),
        ptr=(buf.ptr + nf.sum(1)) % b)
