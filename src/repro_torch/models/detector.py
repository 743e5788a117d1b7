"""MadEye approximation model: a backbone + FPN-lite neck + anchor-free
center/box/class heads (paper §3.1), used only to rank orientations.

Parameters are nested dictionaries in the reference layout
(``{"backbone": {"vit", "neck"}, "heads": {"cls", "box", "obj"}}``),
so `params_from_numpy` carries the JAX package's weights across and
`fleet.runner.load_detector_params` reads its `.npz` checkpoints.

The backbone is the config's: a ViT over the patch tokens (one map at
stride `patch`, the neck a 1x1 lateral and a 3x3 smooth), or Swin
(``{"backbone": {"swin", "neck"}}``: models/swin.py's stages over the
patch tokens, stages and blocks in lists; the neck joins the last two
stages' normed maps, the last upsampled 2x, into the map of the one
before it). Both neck maps are [g, g, fpn_dim], so the
heads, the decode and head-only distillation are shared.

Output per crop: boxes [max_boxes, 4] cxcywh in [0, 1], scores
[max_boxes], class_probs [max_boxes, n_classes], top-`max_boxes` by
score with ties toward the lower cell.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs import DetectorConfig
from repro_torch.models import swin, vit
from repro_torch.models.layers import (
    Params,
    card_kernel_operands,
    conv2d,
    conv_init,
    gelu,
    grid_side,
    layernorm,
    layernorm_init,
)
from repro_torch.obs.trace import span
from repro_torch.train.optim import tree_leaves


class Detections(NamedTuple):
    boxes: torch.Tensor        # [..., max_boxes, 4] cxcywh in [0, 1]
    scores: torch.Tensor       # [..., max_boxes] objectness * class prob
    class_probs: torch.Tensor  # [..., max_boxes, n_classes]


def detector_init(gen: torch.Generator, cfg: DetectorConfig,
                  device=None) -> Params:
    """Fresh weights from a torch.Generator (truncated normals: He for
    convs, LeCun for linears, std 0.02 for the CLS/position tokens and
    Swin's relative-bias tables)."""
    f = cfg.fpn_dim
    if config_backbone(cfg) == "swin":
        return {"backbone": _swin_backbone_init(gen, cfg, device),
                "heads": _heads_init(gen, cfg, device)}
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
        "heads": _heads_init(gen, cfg, device),
    }


def _heads_init(gen, cfg: DetectorConfig, device) -> Params:
    f = cfg.fpn_dim
    return {"cls": conv_init(gen, 3, 3, f, cfg.n_classes, device=device),
            "box": conv_init(gen, 3, 3, f, 4, device=device),
            "obj": conv_init(gen, 3, 3, f, 1, device=device)}


def _swin_backbone_init(gen, cfg: DetectorConfig, device) -> Params:
    """{"swin": patch embed, patch norm, models/swin.py's stages, norm3 /
    norm4 on the last two stages' maps; "neck": lateral3 / lateral4
    (1x1 onto fpn_dim) and smooth (3x3)}."""
    sc, f = cfg.swin, cfg.fpn_dim
    dims = sc.dims
    return {
        "swin": {
            "stages": swin.swin_stages_init(gen, sc, device=device),
            "patch_embed": conv_init(gen, cfg.patch, cfg.patch, 3, dims[0],
                                     device=device),
            "patch_norm": layernorm_init(dims[0], device=device),
            "norm3": layernorm_init(dims[-2], device=device),
            "norm4": layernorm_init(dims[-1], device=device),
        },
        "neck": {
            "lateral3": conv_init(gen, 1, 1, dims[-2], f, device=device),
            "lateral4": conv_init(gen, 1, 1, dims[-1], f, device=device),
            "smooth": conv_init(gen, 3, 3, f, f, device=device),
        },
    }


def config_backbone(cfg) -> str:
    """The backbone cfg names: "swin" where cfg.swin holds a Swin
    config, else "vit" (also for a config without the field: the JAX
    package's DetectorConfig, which the tests hand the port)."""
    return "vit" if getattr(cfg, "swin", None) is None else "swin"


def patch_embed_params(params: Params, cfg: DetectorConfig) -> Params:
    """The conv patch embed ({"w": [p, p, 3, D], "b": [D]}) that
    crop_patchify applies, whichever backbone holds it."""
    return params["backbone"][config_backbone(cfg)]["patch_embed"]


def neck_grid(cfg: DetectorConfig) -> int:
    """Side of the post-neck map: img_res / patch for the ViT; for Swin
    the map of the second-to-last stage, one merge (2x) per stage
    before it."""
    g = cfg.img_res // cfg.patch
    if config_backbone(cfg) == "swin":
        g //= 2 ** (len(cfg.swin.depths) - 2)
    return g


def params_from_numpy(tree, device=None) -> Params:
    """Nested dict of arrays (the reference's detector params) -> the
    same nested dict of float32 tensors on `device`. Tensor leaves are
    moved as they are. Lists (Swin's stages and blocks) stay lists, and
    a dict keyed "0", "1", ... (the same spelled by paths, as a `.npz`
    checkpoint's names spell it) becomes the list."""
    if isinstance(tree, dict):
        if tree and set(tree) == {str(i) for i in range(len(tree))}:
            tree = [tree[str(i)] for i in range(len(tree))]
        else:
            return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
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


def _embed(params: Params, cfg: DetectorConfig,
           images: torch.Tensor) -> torch.Tensor:
    """Images [B, H, W, 3] -> patch tokens (vit.vit_embed with the
    backbone's patch embed)."""
    return vit.vit_embed(params["backbone"][config_backbone(cfg)], images,
                         patch=cfg.patch)


def detector_raw(params: Params, cfg: DetectorConfig,
                 images: torch.Tensor):
    """Images [B, H, W, 3] -> the raw head outputs of `detector_raw_tokens`
    on their patch tokens (vit.vit_embed)."""
    return detector_raw_tokens(params, cfg, _embed(params, cfg, images))


def detector_forward(params: Params, cfg: DetectorConfig,
                     images: torch.Tensor) -> Detections:
    """Images [B, H, W, 3] -> top-`max_boxes` Detections per image (the
    unfused detector path and the serving engine)."""
    return _decode_detections(cfg, *detector_raw(params, cfg, images))


def swin_neck_features(bb: Params, c3: torch.Tensor,
                       c4: torch.Tensor) -> torch.Tensor:
    """The last two Swin stages' normed maps c3 [B, g, g, C3] and c4
    [B, g/2, g/2, C4] -> post-neck map [B, g, g, F]: lateral3(c3) plus
    lateral4(c4) upsampled 2x (nearest), then the smooth conv and GELU."""
    neck = bb["neck"]
    top = conv2d(neck["lateral4"], c4)
    b, h, w, f = top.shape
    top = top[:, :, None, :, None].expand(b, h, 2, w, 2, f).reshape(
        b, 2 * h, 2 * w, f)
    return gelu(conv2d(neck["smooth"], conv2d(neck["lateral3"], c3) + top))


def _swin_maps(sw: Params, cfg: DetectorConfig,
               tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Patch tokens [B, P, D] -> the last two stages' normed maps."""
    b, n_patches, d = tokens.shape
    g = grid_side(n_patches, "tokens")
    x = layernorm(sw["patch_norm"], tokens.reshape(b, g, g, d))
    maps = swin.swin_stages(sw["stages"], cfg.swin, x)
    return layernorm(sw["norm3"], maps[-2]), layernorm(sw["norm4"], maps[-1])


def detector_neck_feats_tokens(params: Params, cfg: DetectorConfig,
                               tokens: torch.Tensor) -> torch.Tensor:
    """Patch tokens [B, P, D] -> post-neck feature map [B, g, g, F]: the
    shared frozen half of the forward when the heads train per camera
    (the same features are staged as the head-only training payload).
    The backbone runs inside the span `madeye/backbone`."""
    bb = params["backbone"]
    if config_backbone(cfg) == "swin":
        with span("madeye/backbone"):
            c3, c4 = _swin_maps(bb["swin"], cfg, tokens)
        return swin_neck_features(bb, c3, c4)
    with span("madeye/backbone"):
        feats = vit.vit_features_tokens(
            bb["vit"], tokens, n_heads=cfg.n_heads,
            impl=vit_attention_impl(tokens, bb["vit"]))
    return neck_features(bb, feats)


def vit_attention_impl(tokens: torch.Tensor, vit_params: Params) -> str:
    """The ViT backbone's attention: "flash", one launch a layer of the
    hand-written kernel, where the tokens and every ViT weight are plain
    float32 CUDA tensors holding values and nothing needs a gradient
    (layers.card_kernel_operands); else "xla": the CPU, training, vmap,
    meshes, meta and fake tensors, none of which the kernel (it has no
    backward) may see."""
    ok = card_kernel_operands(tokens, *tree_leaves(vit_params))
    return "flash" if ok else "xla"


def detector_raw_tokens(params: Params, cfg: DetectorConfig,
                        tokens: torch.Tensor):
    """Patch tokens [B, P, D] -> raw head outputs (cls_logits [B, g, g,
    K], box_raw [B, g, g, 4], obj [B, g, g])."""
    return head_outputs(params["heads"],
                        detector_neck_feats_tokens(params, cfg, tokens))


def detections_from_feats(cfg: DetectorConfig, heads: Params,
                          feats: torch.Tensor) -> Detections:
    """Post-neck features [B, g, g, F] + head params -> Detections."""
    return _decode_detections(cfg, *head_outputs(heads, feats))


def detector_forward_tokens(params: Params, cfg: DetectorConfig,
                            tokens: torch.Tensor) -> Detections:
    """Patch tokens [B, P, D] -> top-`max_boxes` Detections per crop —
    the single batched forward of the candidate-sparse fast path."""
    return _decode_detections(cfg,
                              *detector_raw_tokens(params, cfg, tokens))


# ---------------------------------------------------------------------------
# training loss (distillation target = teacher boxes)
# ---------------------------------------------------------------------------

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


def detector_loss(params: Params, cfg: DetectorConfig, images: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                  gt_valid: torch.Tensor, *, freeze_backbone: bool = True):
    """The detector loss over a full image forward (images [B, H, W, 3]).
    freeze_backbone detaches the post-neck features, so no gradient
    reaches params["backbone"] (the host-side fine-tune trains the heads
    only)."""
    feats = detector_neck_feats_tokens(params, cfg,
                                       _embed(params, cfg, images))
    if freeze_backbone:
        feats = feats.detach()
    return detector_loss_from_outputs(
        *head_outputs(params["heads"], feats), gt_boxes, gt_classes,
        gt_valid)


def detector_loss_tokens(params: Params, cfg: DetectorConfig,
                         tokens: torch.Tensor, gt_boxes: torch.Tensor,
                         gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                         *, weight: torch.Tensor | None = None):
    """The detector loss from patch-embedding tokens [B, P, D] — the
    full-param distillation objective (the staged payload is the
    crop_patchify token buffer, re-run through the trainable
    backbone)."""
    return detector_loss_from_outputs(
        *detector_raw_tokens(params, cfg, tokens),
        gt_boxes, gt_classes, gt_valid, weight=weight)


def head_params_mask(params: Params) -> Params:
    """Mask tree: True for fine-tuned (head) leaves, False elsewhere."""
    def const(tree, value):
        if isinstance(tree, dict):
            return {k: const(v, value) for k, v in tree.items()}
        return value

    return {k: const(v, k == "heads") for k, v in params.items()}
