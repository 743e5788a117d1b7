"""MadEye approximation model: ViT backbone + FPN-lite neck + anchor-free
center/box/class heads (paper §3.1), used only to rank orientations.

Parameters are nested dictionaries in the reference layout
(``{"backbone": {"vit", "neck"}, "heads": {"cls", "box", "obj"}}``),
so `params_from_numpy` carries the JAX package's weights across and
`fleet.runner.load_detector_params` reads its `.npz` checkpoints.

Output per crop: boxes [max_boxes, 4] cxcywh in [0, 1], scores
[max_boxes], class_probs [max_boxes, n_classes], top-`max_boxes` by
score with ties toward the lower cell.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import DetectorConfig
from repro_torch.models import vit
from repro_torch.models.layers import Params, conv2d, conv_init, gelu


class Detections(NamedTuple):
    boxes: torch.Tensor        # [..., max_boxes, 4] cxcywh in [0, 1]
    scores: torch.Tensor       # [..., max_boxes] objectness * class prob
    class_probs: torch.Tensor  # [..., max_boxes, n_classes]


def detector_init(gen: torch.Generator, cfg: DetectorConfig,
                  device=None) -> Params:
    """Fresh weights from a torch.Generator (truncated normals: He for
    convs, LeCun for linears, std 0.02 for the CLS/position tokens)."""
    f = cfg.fpn_dim
    return {
        "backbone": {
            "vit": vit.vit_init(gen, img_res=cfg.img_res, patch=cfg.patch,
                                n_layers=cfg.n_layers, d_model=cfg.d_model,
                                n_heads=cfg.n_heads, d_ff=cfg.d_ff,
                                device=device),
            "neck": {
                "lateral": conv_init(gen, 1, 1, cfg.d_model, f,
                                     device=device),
                "smooth": conv_init(gen, 3, 3, f, f, device=device),
            },
        },
        "heads": {
            "cls": conv_init(gen, 3, 3, f, cfg.n_classes, device=device),
            "box": conv_init(gen, 3, 3, f, 4, device=device),
            "obj": conv_init(gen, 3, 3, f, 1, device=device),
        },
    }


def params_from_numpy(tree, device=None) -> Params:
    """Nested dict of arrays (the reference's detector params) -> the
    same nested dict of float32 tensors on `device`. Tensor leaves are
    moved as they are."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.array(tree, np.float32), device=device)


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


def _decode_detections(cfg: DetectorConfig, cls_logits, box_raw,
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


def detector_forward_tokens(params: Params, cfg: DetectorConfig,
                            tokens: torch.Tensor) -> Detections:
    """Patch tokens [B, P, D] -> top-`max_boxes` Detections per crop —
    the single batched forward of the candidate-sparse fast path."""
    bb = params["backbone"]
    feats = vit.vit_features_tokens(bb["vit"], tokens, n_heads=cfg.n_heads)
    return _decode_detections(
        cfg, *head_outputs(params["heads"], neck_features(bb, feats)))
