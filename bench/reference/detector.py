"""The madeye-approx detector, plain PyTorch: ViT backbone over patch
tokens, FPN-lite neck, anchor-free center/box/class heads, top-k decode,
and the anchor-free loss the distillation update minimises.

Parameters are nested dictionaries (``{"backbone": {"vit", "neck"},
"heads": {"cls", "box", "obj"}}``, ViT layers stacked on a leading
[n_layers] axis). Output per crop: boxes [max_boxes, 4] cxcywh in
[0, 1], scores [max_boxes], class_probs [max_boxes, n_classes],
top-`max_boxes` by score with ties toward the lower cell.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bench.reference.layers import (
    Params,
    attention,
    conv2d,
    gelu,
    layernorm,
    mlp,
)


class Detections(NamedTuple):
    boxes: torch.Tensor        # [..., max_boxes, 4] cxcywh in [0, 1]
    scores: torch.Tensor       # [..., max_boxes] objectness * class prob
    class_probs: torch.Tensor  # [..., max_boxes, n_classes]


def vit_features_tokens(vit: Params, tokens: torch.Tensor,
                        n_heads: int) -> torch.Tensor:
    """Patch tokens [B, P, D] (square P) -> feature map [B, g, g, D]:
    CLS prepended, position embeddings added, pre-norm blocks, final
    LayerNorm, CLS dropped."""
    b, n_patches, d = tokens.shape
    g = int(round(n_patches ** 0.5))
    x = torch.cat([vit["cls_token"].expand(b, 1, d), tokens], dim=1)
    x = x + vit["pos_embed"]
    layers = vit["layers"]
    for i in range(layers["norm1"]["scale"].shape[0]):
        p = _layer(layers, i)
        x = x + attention(p["attn"], layernorm(p["norm1"], x), n_heads)
        x = x + mlp(p["mlp"], layernorm(p["norm2"], x))
    x = layernorm(vit["final_norm"], x)
    return x[:, 1:].reshape(b, g, g, d)


def _layer(stacked, i: int):
    if isinstance(stacked, dict):
        return {k: _layer(v, i) for k, v in stacked.items()}
    return stacked[i]


def neck_features(bb: Params, feats: torch.Tensor) -> torch.Tensor:
    """backbone feature map [B, g, g, D] -> post-neck map [B, g, g, F]."""
    f = conv2d(bb["neck"]["lateral"], feats)
    return gelu(conv2d(bb["neck"]["smooth"], f))


def head_outputs(heads: Params, f: torch.Tensor):
    """post-neck features [B, g, g, F] -> (cls_logits, box_raw, obj)."""
    return (conv2d(heads["cls"], f), conv2d(heads["box"], f),
            conv2d(heads["obj"], f)[..., 0])


def decode_boxes(box_raw: torch.Tensor) -> torch.Tensor:
    """[B, g, g, 4] raw -> cxcywh in [0, 1] (cell-relative center +
    global size)."""
    g = box_raw.shape[1]
    ar = torch.arange(g, device=box_raw.device)
    ys, xs = torch.meshgrid(ar, ar, indexing="ij")
    off = torch.sigmoid(box_raw[..., :2])
    cx = (xs[None] + off[..., 0]) / g
    cy = (ys[None] + off[..., 1]) / g
    wh = torch.sigmoid(box_raw[..., 2:])
    return torch.stack([cx, cy, wh[..., 0], wh[..., 1]], dim=-1)


def _decode_detections(cfg, cls_logits, box_raw,
                       obj_logits) -> Detections:
    b, g = cls_logits.shape[0], cls_logits.shape[1]
    boxes = decode_boxes(box_raw).reshape(b, g * g, 4)
    cls_probs = torch.softmax(cls_logits.reshape(b, g * g, -1), dim=-1)
    obj = torch.sigmoid(obj_logits.reshape(b, g * g))
    scores = obj * cls_probs.max(-1).values

    # top-k with ties toward the lower index: a stable descending sort
    k = min(cfg.max_boxes, g * g)
    top_scores, idx = torch.sort(scores, dim=-1, descending=True,
                                 stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    top_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    top_probs = torch.gather(
        cls_probs, 1, idx[..., None].expand(-1, -1, cls_probs.shape[-1]))
    pad = cfg.max_boxes - k
    if pad > 0:
        top_scores = torch.nn.functional.pad(top_scores, (0, pad))
        top_boxes = torch.nn.functional.pad(top_boxes, (0, 0, 0, pad))
        top_probs = torch.nn.functional.pad(top_probs, (0, 0, 0, pad))
    return Detections(top_boxes, top_scores, top_probs)


def detector_loss_from_outputs(cls_logits: torch.Tensor,
                               box_raw: torch.Tensor,
                               obj_logits: torch.Tensor,
                               gt_boxes: torch.Tensor,
                               gt_classes: torch.Tensor,
                               gt_valid: torch.Tensor,
                               weight: torch.Tensor | None = None):
    """The anchor-free single-level loss on raw head outputs: focal-style
    objectness BCE over every cell, class NLL and box L1 over the cells
    a valid ground-truth center falls in. gt_boxes [B, N, 4] cxcywh,
    gt_classes [B, N] int, gt_valid [B, N] bool; `weight` [B] weighs
    samples (empty ring slots 0), None is the unweighted mean.

    Dense targets as the reference's scatter builds them: objectness is
    the max over the slots of a cell; class and box come from the LAST
    slot (in slot order) that lands in a cell, where an invalid slot
    lands in cell 0 and writes the zero target there. That order is
    taken explicitly (the largest slot index per cell), so the result
    does not depend on the order a device applies repeated writes in.
    """
    b, g = cls_logits.shape[0], cls_logits.shape[1]
    k = cls_logits.shape[-1]
    n = gt_boxes.shape[1]
    dev = cls_logits.device

    # assign each GT to the cell holding its center
    ci = torch.clamp((gt_boxes[..., 0] * g).to(torch.int32), 0, g - 1)
    cj = torch.clamp((gt_boxes[..., 1] * g).to(torch.int32), 0, g - 1)
    cell = torch.where(gt_valid, cj * g + ci, 0).long()        # [B, N]

    hit = cell[..., None] == torch.arange(g * g, device=dev)   # [B, N, C]
    v = gt_valid.float()
    obj_t = torch.where(hit, v[..., None], 0.0).amax(1)       # [B, C]
    slot = torch.arange(1, n + 1, device=dev)[None, :, None]
    last = torch.where(hit, slot, 0).amax(1)                  # [B, C]
    src = torch.clamp(last - 1, min=0)
    cls_src = torch.where(gt_valid, gt_classes.long(), 0)
    box_src = torch.where(gt_valid[..., None], gt_boxes.float(), 0.0)
    cls_t = torch.where(last > 0, torch.gather(cls_src, 1, src), 0)
    box_t = torch.where((last > 0)[..., None], torch.gather(
        box_src, 1, src[..., None].expand(-1, -1, 4)), 0.0)

    obj_logits = obj_logits.reshape(b, g * g).float()
    cls_logits = cls_logits.reshape(b, g * g, k).float()
    pred_boxes = decode_boxes(box_raw).reshape(b, g * g, 4)

    # focal-style objectness BCE
    p = torch.sigmoid(obj_logits)
    bce = -(obj_t * torch.log(p + 1e-8)
            + (1 - obj_t) * torch.log(1 - p + 1e-8))
    focal_w = torch.where(obj_t > 0, (1 - p) ** 2, p ** 2)
    pos = obj_t
    logp = torch.log_softmax(cls_logits, dim=-1)
    cls_nll = -torch.gather(logp, -1, cls_t[..., None])[..., 0]
    box_l1 = torch.abs(pred_boxes - box_t)

    if weight is None:
        obj_loss = torch.mean(focal_w * bce)
        n_pos = torch.clamp(torch.sum(pos), min=1.0)
        cls_loss = torch.sum(pos * cls_nll) / n_pos
        box_loss = torch.sum(pos[..., None] * box_l1) / n_pos
    else:
        w = weight.float()[:, None]                             # [B, 1]
        obj_loss = (torch.sum(w * focal_w * bce)
                    / torch.clamp(torch.sum(w) * (g * g), min=1.0))
        wpos = w * pos
        n_pos = torch.clamp(torch.sum(wpos), min=1.0)
        cls_loss = torch.sum(wpos * cls_nll) / n_pos
        box_loss = torch.sum(wpos[..., None] * box_l1) / n_pos

    return obj_loss + cls_loss + box_loss


def detections_from_feats(cfg, heads: Params,
                          feats: torch.Tensor) -> Detections:
    """Post-neck features [B, g, g, F] + head params -> Detections."""
    return _decode_detections(cfg, *head_outputs(heads, feats))


def detector_neck_feats_tokens(params: Params, cfg, tokens: torch.Tensor
                               ) -> torch.Tensor:
    """Patch tokens [B, P, D] -> post-neck feature map [B, g, g, F]."""
    bb = params["backbone"]
    return neck_features(bb, vit_features_tokens(bb["vit"], tokens,
                                                 cfg.n_heads))


def detector_forward_tokens(params: Params, cfg, tokens: torch.Tensor
                            ) -> Detections:
    """Patch tokens [B, P, D] -> top-`max_boxes` Detections per crop."""
    return detections_from_feats(
        cfg, params["heads"], detector_neck_feats_tokens(params, cfg,
                                                         tokens))
