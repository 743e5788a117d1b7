"""The Swin detector (`"model": "swin_detector"`): a Swin Transformer
backbone (arXiv:2103.14030) over the patch tokens of each crop, a
two-level neck on its last two stages, and MadEye's anchor-free heads.
The harness reads the functions `bench/models/vit_detector.py` lists,
with the same contracts; the plain reference is
`bench/reference/swin_detector.py`.

The module imports nothing of the port at its top: only `program` does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from bench.reference.crop_patchify import crop_patchify
from bench.reference.swin_detector import (
    HEAD_DIM,
    TABLE_WINDOW,
    swin_detector_forward_tokens,
    swin_neck_feats_tokens,
)

MLP_RATIO = 4


@dataclass(frozen=True)
class Sizes:
    """The detector's sizes and score threshold."""
    name: str
    img_res: int
    patch: int
    window: int
    depths: tuple
    dims: tuple
    n_classes: int
    max_boxes: int
    fpn_dim: int
    score_thresh: float


def sizes(config: dict) -> Sizes:
    """The configuration's sizes. Its `heads` and `mlp_ratio` must be
    the ones the port builds (dim / 32 heads, MLP 4x)."""
    dims = tuple(config["dims"])
    heads = [d // HEAD_DIM for d in dims]
    if list(config["heads"]) != heads or config["mlp_ratio"] != MLP_RATIO:
        raise ValueError(f"{config['name']}: heads must be dim / "
                         f"{HEAD_DIM} ({heads}) and mlp_ratio {MLP_RATIO}")
    return Sizes(name=config["name"], img_res=config["img_res"],
                 patch=config["patch"], window=config["window"],
                 depths=tuple(config["depths"]), dims=dims,
                 n_classes=config["n_classes"],
                 max_boxes=config["max_boxes"], fpn_dim=config["fpn_dim"],
                 score_thresh=config["score_thresh"])


def _maps(s: Sizes) -> list:
    """The side of each stage's map."""
    g = s.img_res // s.patch
    return [g // 2 ** i for i in range(len(s.dims))]


def leaves(s: Sizes) -> dict:
    """leaf path -> (shape, std); std None: zeros, "one": ones. Truncated
    normals scaled per leaf: He for convolutions, LeCun for linears,
    0.02 for the relative-bias tables."""
    f = s.fpn_dim
    rows = (2 * max(s.window, TABLE_WINDOW) - 1) ** 2

    def lin(pre, a, b, bias=True):
        out = {f"{pre}/w": ((a, b), math.sqrt(1.0 / a))}
        if bias:
            out[f"{pre}/b"] = ((b,), None)
        return out

    def conv(pre, k, a, b):
        return {f"{pre}/w": ((k, k, a, b), math.sqrt(2.0 / (k * k * a))),
                f"{pre}/b": ((b,), None)}

    def norm(pre, d):
        return {f"{pre}/scale": ((d,), "one"), f"{pre}/bias": ((d,), None)}

    sw = "backbone/swin"
    out = {**conv(f"{sw}/patch_embed", s.patch, 3, s.dims[0]),
           **norm(f"{sw}/patch_norm", s.dims[0])}
    for i, (depth, d) in enumerate(zip(s.depths, s.dims)):
        st = f"{sw}/stages/{i}"
        for j in range(depth):
            b = f"{st}/blocks/{j}"
            out.update(norm(f"{b}/norm1", d))
            for n in ("wq", "wk", "wv", "wo"):
                out.update(lin(f"{b}/attn/{n}", d, d))
            out[f"{b}/rel_bias"] = ((rows, d // HEAD_DIM), 0.02)
            out.update(norm(f"{b}/norm2", d))
            out.update(lin(f"{b}/mlp/up", d, MLP_RATIO * d))
            out.update(lin(f"{b}/mlp/down", MLP_RATIO * d, d))
        if i < len(s.dims) - 1:
            out.update(norm(f"{st}/merge/norm", 4 * d))
            out.update(lin(f"{st}/merge/reduce", 4 * d, 2 * d, bias=False))
    out.update(norm(f"{sw}/norm3", s.dims[-2]))
    out.update(norm(f"{sw}/norm4", s.dims[-1]))
    out.update(conv("backbone/neck/lateral3", 1, s.dims[-2], f))
    out.update(conv("backbone/neck/lateral4", 1, s.dims[-1], f))
    out.update(conv("backbone/neck/smooth", 3, f, f))
    out.update(conv("heads/cls", 3, f, s.n_classes))
    out.update(conv("heads/box", 3, f, 4))
    out.update(conv("heads/obj", 3, f, 1))
    return out


def program(s: Sizes) -> tuple[str, dict]:
    """The port's provider and the model's part of its kwargs: a
    DetectorConfig that holds the backbone's Swin VisionConfig (its
    ViT-style fields as configs/swin_b.py fills them), float32."""
    import torch
    from repro_torch.configs import DetectorConfig, VisionConfig

    backbone = VisionConfig(
        name=s.name, img_res=s.img_res, patch=s.patch,
        n_layers=sum(s.depths), d_model=s.dims[0],
        n_heads=s.dims[0] // HEAD_DIM, d_ff=MLP_RATIO * s.dims[0],
        swin=True, window=s.window, depths=s.depths, dims=s.dims,
        dtype=torch.float32)
    return "detector", {"det_cfg": DetectorConfig(
        name=s.name, img_res=s.img_res, patch=s.patch,
        n_classes=s.n_classes, max_boxes=s.max_boxes, fpn_dim=s.fpn_dim,
        swin=backbone)}


def crop_flops(s: Sizes) -> float:
    """Forward FLOPs of one crop (2 per multiply-add): the patch embed;
    per block at t tokens of width d in windows of w^2 tokens, the q, k,
    v and output projections, scores and values over each token's
    window, and the MLP; the merges; the neck and the heads."""
    maps = _maps(s)
    flops = 2 * maps[0] ** 2 * s.patch * s.patch * 3 * s.dims[0]
    for i, (depth, d, side) in enumerate(zip(s.depths, s.dims, maps)):
        t = side * side
        w = min(s.window, side)
        block = (2 * t * d * 4 * d + 2 * 2 * t * w * w * d
                 + 2 * 2 * t * d * MLP_RATIO * d)
        flops += depth * block
        if i < len(s.dims) - 1:
            flops += 2 * (t // 4) * 4 * d * 2 * d
    g3, g4 = maps[-2] ** 2, maps[-1] ** 2
    f = s.fpn_dim
    neck = (2 * g3 * s.dims[-2] * f + 2 * g4 * s.dims[-1] * f
            + 2 * g3 * 9 * f * f)
    return flops + neck + head_flops(s)


def head_flops(s: Sizes) -> float:
    """Forward FLOPs of the three 3x3 head convolutions on one crop."""
    g = _maps(s)[-2]
    return 2 * g * g * 9 * s.fpn_dim * (s.n_classes + 4 + 1)


def patch_embed(s: Sizes) -> tuple[int, int, int]:
    """(patch, crop resolution, token width) of `crop_patchify`."""
    return s.patch, s.img_res, s.dims[0]


def neck_shape(s: Sizes) -> tuple[int, int, int]:
    g = _maps(s)[-2]
    return g, g, s.fpn_dim


def reference_detect(s: Sizes, weights, sc, kinds, windows, noise, *,
                     min_visible: float, block_k: int,
                     feats_only: bool = False):
    """The scene `sc` seen through `windows` [F, K, 4] with `noise` ->
    crop_patchify's patch tokens -> the reference Swin detector:
    Detections with leaves [F, K, ...], or with `feats_only` the
    post-neck features [F, K, g, g, fpn]."""
    tokens = crop_patchify(
        sc.pos, sc.size, kinds, sc.oid, windows,
        weights["backbone"]["swin"]["patch_embed"], patch=s.patch,
        res=s.img_res, min_visible=min_visible, noise=noise,
        block_k=block_k)
    f, k = tokens.shape[:2]
    flat = tokens.reshape((f * k,) + tokens.shape[2:])
    if feats_only:
        feats = swin_neck_feats_tokens(weights, s, flat)
        return feats.reshape((f, k) + feats.shape[1:])
    dets = swin_detector_forward_tokens(weights, s, flat)
    return type(dets)(*(x.reshape((f, k) + x.shape[1:]) for x in dets))
