"""The madeye-approx detector (`"model": "vit_detector"`): a ViT backbone
over the patch tokens of each crop, an FPN-lite neck and anchor-free
heads. Everything of the benchmark that depends on the model's
architecture lives here; the harness finds this file by the name a
configuration gives and reads these functions:

  sizes(config)       the sizes object the rest of the harness reads
  leaves(s)           the weight leaves {path: (shape, std)}, in the
                      order `bench.harness.weights.make_weights` draws
  program(s)          (provider name, the model's provider kwargs) for
                      the port's `FleetRunSpec`
  crop_flops(s), head_flops(s), patch_embed(s)
                      operation counts of one crop's forward, of the
                      heads, and the patch embed's (patch, res, width)
  neck_shape(s)       the post-neck map of one crop (rows, cols, width)
  reference_detect    the plain reference from the shortlisted windows
                      and the noise to detections (or post-neck
                      features)

The module imports nothing of the port at its top: only `program` does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from bench.reference.crop_patchify import crop_patchify
from bench.reference.detector import (
    detector_forward_tokens,
    detector_neck_feats_tokens,
)

# the detector's sizes, as a configuration file names them
KEYS = ("img_res", "patch", "n_layers", "d_model", "n_heads", "d_ff",
        "n_classes", "max_boxes", "fpn_dim")


@dataclass(frozen=True)
class Sizes:
    """The detector's sizes and score threshold (attribute access, as
    both the program's DetectorConfig and the reference read them)."""
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int
    max_boxes: int
    fpn_dim: int
    score_thresh: float


def sizes(config: dict) -> Sizes:
    return Sizes(name=config["name"], score_thresh=config["score_thresh"],
                 **{k: config[k] for k in KEYS})


def leaves(s: Sizes) -> dict:
    """leaf path -> (shape, std); std None: zeros, "one": ones. Truncated
    normals scaled per leaf: He for convolutions, LeCun for linears,
    0.02 for the CLS and position tokens; ViT layers stacked on a
    leading axis."""
    d, L, ff, f, p = s.d_model, s.n_layers, s.d_ff, s.fpn_dim, s.patch
    gg = (s.img_res // p) ** 2

    def lin(pre, a, b, stack=True):
        lead = (L,) if stack else ()
        return {f"{pre}/w": (lead + (a, b), math.sqrt(1.0 / a)),
                f"{pre}/b": (lead + (b,), None)}

    def conv(pre, k, a, b):
        return {f"{pre}/w": ((k, k, a, b), math.sqrt(2.0 / (k * k * a))),
                f"{pre}/b": ((b,), None)}

    def norm(pre, stack=True):
        lead = (L,) if stack else ()
        return {f"{pre}/scale": (lead + (d,), "one"),
                f"{pre}/bias": (lead + (d,), None)}

    v = "backbone/vit"
    out = {**conv(f"{v}/patch_embed", p, 3, d),
           f"{v}/cls_token": ((1, 1, d), 0.02),
           f"{v}/pos_embed": ((1, gg + 1, d), 0.02)}
    out.update(norm(f"{v}/layers/norm1"))
    for n in ("wq", "wk", "wv", "wo"):
        out.update(lin(f"{v}/layers/attn/{n}", d, d))
    out.update(norm(f"{v}/layers/norm2"))
    out.update(lin(f"{v}/layers/mlp/up", d, ff))
    out.update(lin(f"{v}/layers/mlp/down", ff, d))
    out.update(norm(f"{v}/final_norm", stack=False))
    out.update(lin(f"{v}/head", d, s.n_classes, stack=False))
    out.update(conv("backbone/neck/lateral", 1, d, f))
    out.update(conv("backbone/neck/smooth", 3, f, f))
    out.update(conv("heads/cls", 3, f, s.n_classes))
    out.update(conv("heads/box", 3, f, 4))
    out.update(conv("heads/obj", 3, f, 1))
    return out


def program(s: Sizes) -> tuple[str, dict]:
    """The port's provider and the model's part of its kwargs."""
    from repro_torch.configs import DetectorConfig

    return "detector", {"det_cfg": DetectorConfig(
        name=s.name, img_res=s.img_res, patch=s.patch, n_layers=s.n_layers,
        d_model=s.d_model, n_heads=s.n_heads, d_ff=s.d_ff,
        n_classes=s.n_classes, max_boxes=s.max_boxes, fpn_dim=s.fpn_dim)}


def crop_flops(s: Sizes) -> float:
    """Forward FLOPs of one crop (2 per multiply-add): the patch embed,
    the ViT over 1 + (res/patch)^2 tokens, the neck and the heads."""
    d, ff, f = s.d_model, s.d_ff, s.fpn_dim
    gg = (s.img_res // s.patch) ** 2
    t = gg + 1
    embed = 2 * gg * s.patch * s.patch * 3 * d
    layer = (2 * t * d * 3 * d + 2 * 2 * t * t * d + 2 * t * d * d
             + 2 * 2 * t * d * ff)
    neck = 2 * gg * d * f + 2 * gg * 9 * f * f
    return embed + s.n_layers * layer + neck + head_flops(s)


def head_flops(s: Sizes) -> float:
    """Forward FLOPs of the three 3x3 head convolutions on one crop."""
    gg = (s.img_res // s.patch) ** 2
    return 2 * gg * 9 * s.fpn_dim * (s.n_classes + 4 + 1)


def patch_embed(s: Sizes) -> tuple[int, int, int]:
    """(patch, crop resolution, token width) of `crop_patchify`."""
    return s.patch, s.img_res, s.d_model


def neck_shape(s: Sizes) -> tuple[int, int, int]:
    g = s.img_res // s.patch
    return g, g, s.fpn_dim


def reference_detect(s: Sizes, weights, sc, kinds, windows, noise, *,
                     min_visible: float, block_k: int,
                     feats_only: bool = False):
    """The scene `sc` seen through `windows` [F, K, 4] with `noise` ->
    crop_patchify's patch tokens -> the reference detector: Detections
    with leaves [F, K, ...], or with `feats_only` the post-neck features
    [F, K, g, g, fpn] that each camera's own heads take."""
    tokens = crop_patchify(
        sc.pos, sc.size, kinds, sc.oid, windows,
        weights["backbone"]["vit"]["patch_embed"], patch=s.patch,
        res=s.img_res, min_visible=min_visible, noise=noise,
        block_k=block_k)
    f, k = tokens.shape[:2]
    flat = tokens.reshape((f * k,) + tokens.shape[2:])
    if feats_only:
        feats = detector_neck_feats_tokens(weights, s, flat)
        return feats.reshape((f, k) + feats.shape[1:])
    dets = detector_forward_tokens(weights, s, flat)
    return type(dets)(*(x.reshape((f, k) + x.shape[1:]) for x in dets))
