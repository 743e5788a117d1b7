"""Box IoU (plain PyTorch version and the CUDA kernel's wrapper,
csrc/box_iou.cu) and its static-shape consumers: greedy NMS as a keep
mask and greedy one-to-one matching.

NMS and matching are plain PyTorch loops run exactly N times around the
kernel's matrix, with argmax ties toward the lowest index (as
jnp.argmax), so their shapes stay fixed and nothing waits on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib


def _corners(b: torch.Tensor):
    return (b[..., 0] - b[..., 2] * 0.5, b[..., 1] - b[..., 3] * 0.5,
            b[..., 0] + b[..., 2] * 0.5, b[..., 1] + b[..., 3] * 0.5)


def box_iou_plain(boxes_a: torch.Tensor,
                  boxes_b: torch.Tensor) -> torch.Tensor:
    """[N, 4] x [M, 4] cxcywh -> [N, M] IoU (float32)."""
    ax0, ay0, ax1, ay1 = _corners(boxes_a.float())
    bx0, by0, bx1, by1 = _corners(boxes_b.float())
    ix0 = torch.maximum(ax0[:, None], bx0[None, :])
    iy0 = torch.maximum(ay0[:, None], by0[None, :])
    ix1 = torch.minimum(ax1[:, None], bx1[None, :])
    iy1 = torch.minimum(ay1[:, None], by1[None, :])
    inter = (torch.clamp(ix1 - ix0, min=0.0)
             * torch.clamp(iy1 - iy0, min=0.0))
    area_a = (ax1 - ax0) * (ay1 - ay0)
    area_b = (bx1 - bx0) * (by1 - by0)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def box_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """[N, 4] x [M, 4] cxcywh -> [N, M] IoU, any N and M. CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise)."""
    for name, x in (("boxes_a", boxes_a), ("boxes_b", boxes_b)):
        if x.dim() != 2 or x.shape[1] != 4:
            raise ValueError(f"box_iou: {name} must be [N, 4], got "
                             f"{tuple(x.shape)}")
    if boxes_a.device.type == "cpu":
        return box_iou_plain(boxes_a, boxes_b)
    _lib.check_cuda("box_iou", boxes_a, boxes_b)
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    out = torch.empty((n, m), dtype=torch.float32, device=boxes_a.device)
    if out.numel() == 0:
        return out
    _lib.launch("box_iou", boxes_a.device, boxes_a.data_ptr(),
                boxes_b.data_ptr(), out.data_ptr(), n, m)
    return out


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor,
             valid: torch.Tensor, *,
             iou_thresh: float = 0.5) -> torch.Tensor:
    """Greedy NMS over a static box budget: boxes [N, 4] cxcywh, scores
    [N], valid [N] bool -> keep mask [N] bool. Runs exactly N rounds;
    each keeps the highest remaining score and suppresses the boxes that
    overlap it by >= iou_thresh."""
    n = boxes.shape[0]
    iou = box_iou(boxes, boxes)
    idx = torch.arange(n, device=boxes.device)
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    alive = valid & (scores > 0)
    for _ in range(n):
        i = torch.argmax(torch.where(alive, scores, float("-inf")))
        any_alive = alive.any()
        picked = (idx == i) & any_alive
        keep = keep | picked
        alive = torch.where(any_alive,
                            alive & ~(iou[i] >= iou_thresh) & (idx != i),
                            alive)
    return keep & valid


def match_boxes(pred: torch.Tensor, gt: torch.Tensor,
                gt_valid: torch.Tensor, *, iou_thresh: float = 0.5):
    """Greedy one-to-one matching (mAP-style true positives): pred [N, 4]
    sorted by score, gt [M, 4], gt_valid [M] -> (is_tp [N] bool,
    matched_gt [N] int32, -1 where unmatched)."""
    n, m = pred.shape[0], gt.shape[0]
    if n == 0:
        return (torch.zeros(0, dtype=torch.bool, device=pred.device),
                torch.zeros(0, dtype=torch.int32, device=pred.device))
    iou = torch.where(gt_valid[None, :], box_iou(pred, gt), -1.0)
    gidx = torch.arange(m, device=pred.device)
    taken = torch.zeros(m, dtype=torch.bool, device=pred.device)
    is_tp, match = [], []
    for i in range(n):
        row = torch.where(taken, -1.0, iou[i])
        j = torch.argmax(row)
        ok = row[j] >= iou_thresh
        taken = taken | ((gidx == j) & ok)
        is_tp.append(ok)
        match.append(torch.where(ok, j, -1))
    return torch.stack(is_tp), torch.stack(match).to(torch.int32)
