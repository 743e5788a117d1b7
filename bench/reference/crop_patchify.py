"""Candidate crops -> ViT patch-embedding tokens, plain PyTorch: render
every (camera, window) crop with the one renderer (render
.render_crops_plain: last-painter-wins ownership in words of 32 lanes),
then apply the conv patch-embed (stride = patch, VALID) as a patchify +
matrix product (layers.patch_embed).
"""
from __future__ import annotations

import torch

from bench.reference.layers import patch_embed
from bench.reference.render import (
    object_colors,
    render_background,
    render_crops_plain,
)


def crop_patchify_plain(ox, oy, ow, oh, colors, windows, bgn, wflat, bias,
                        *, res: int, patch: int,
                        min_visible: float) -> torch.Tensor:
    """Render (scene/render.render_crops_plain) + the conv patch-embed
    (models/layers.patch_embed, as vit_embed computes it). wflat
    [p*p*3, D] (HWIO weights flattened), bias [D] -> tokens [F, K,
    (res/p)^2, D]."""
    crops = render_crops_plain(ox, oy, ow, oh, colors, windows, bgn,
                               res=res, min_visible=min_visible)
    f, k = crops.shape[:2]
    tok = patch_embed(crops.reshape((f * k,) + crops.shape[2:]), wflat,
                      bias, patch=patch)
    return tok.reshape((f, k) + tok.shape[1:])



def crop_patchify(pos, size, kind, oid, windows, patch_params, *,
                  patch: int, res: int, min_visible: float = 0.25,
                  noise=None, block_k: int | None = None) -> torch.Tensor:
    """pos/size [F, M, 2], kind [M], oid [F, M]; windows [F, K, 4] or
    [K, 4] fleet-shared; patch_params {"w": [p, p, 3, D], "b": [D]} (the
    conv patch-embed, HWIO); noise [F, res, res, 3] or None.
    -> tokens [F, K, (res/p)^2, D].

    `block_k` (must divide K) renders the window axis in slabs so the
    transient pixel buffer peaks at [F, block_k, res, res, 3]."""
    if res % patch != 0:
        raise ValueError(f"res={res} must be a multiple of patch={patch}")
    k = windows.shape[-2]
    if block_k is not None and (block_k <= 0 or k % block_k != 0):
        raise ValueError(f"block_k={block_k} must divide the {k} windows")
    dev = pos.device
    colors = object_colors(kind, oid).to(torch.float32).contiguous()
    bgn = render_background(res, dev)[None]
    if noise is not None:
        bgn = bgn + noise
    bgn = bgn.expand(pos.shape[0], res, res, 3).contiguous()
    wflat = patch_params["w"].to(torch.float32).reshape(
        patch * patch * 3, -1).contiguous()
    bias = patch_params.get("b")
    bias = (torch.zeros(wflat.shape[1], device=dev) if bias is None
            else bias.to(torch.float32).contiguous())
    strips = [x.contiguous() for x in (pos[..., 0], pos[..., 1],
                                       size[..., 0], size[..., 1])]
    windows = windows.to(torch.float32).contiguous()

    def run(w):
        return crop_patchify_plain(*strips, colors, w, bgn, wflat, bias,
                                   res=res, patch=patch,
                                   min_visible=min_visible)

    if block_k is None or block_k >= k:
        return run(windows)
    return torch.cat([run(windows[..., s:s + block_k, :].contiguous())
                      for s in range(0, k, block_k)], dim=1)
