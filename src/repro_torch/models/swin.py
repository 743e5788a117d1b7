"""Swin Transformer (Swin-B): windowed and shifted-window attention,
patch merging between stages, as functions on the reference's parameter
dictionaries. Stages are Python loops (their dims differ), each stage's
blocks a list, as in the reference.

Layout: NHWC feature maps between stages; windows flattened for
attention. Attention is the plain biased path (models/attention.
window_attention), as the reference's is. The relative-position index
and the shifted-window masks are built once per (map size, window,
shift, device) and reused, so a forward copies nothing to the device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import VisionConfig
from repro_torch.devices import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    Params,
    batch_rows,
    constrain_spec,
    conv_init,
    dp_entry,
    layernorm,
    layernorm_init,
    linear,
    linear_init,
    mlp,
    mlp_init,
    patch_embed,
    shape_only,
    trunc_normal,
)
from repro_torch.models.vit import classifier_nll

MAX_WINDOW = 12  # rel-bias tables sized for the largest window (384-res)


def _rel_position_index(window: int) -> np.ndarray:
    """[w^2, w^2] index into the (2w-1)^2 relative-bias table. A table
    sized for MAX_WINDOW is read in its first (2w-1)^2 rows, as the
    reference reads it."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))    # [2, w, w]
    flat = coords.reshape(2, -1)                     # [2, w^2]
    rel = flat[:, :, None] - flat[:, None, :]        # [2, w^2, w^2]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


_CONSTANTS: dict = {}


def _constant(key: tuple, device, build) -> torch.Tensor:
    """build() once per key and device; where tensors carry no values
    (the meta device, a FakeTensorMode) built anew, never kept."""
    if shape_only(device):
        return build()
    key = key + (torch.device(device),)
    if key not in _CONSTANTS:
        _CONSTANTS[key] = build()
    return _CONSTANTS[key]


def rel_index(window: int, device) -> torch.Tensor:
    """_rel_position_index(window) on `device`, made once."""
    return _constant(("rel_index", window), device, lambda: torch.as_tensor(
        _rel_position_index(window), device=device))


def shift_mask(h: int, w: int, window: int, shift: int,
               device) -> torch.Tensor:
    """attention.shifted_window_mask on `device`, made once."""
    return _constant(("mask", h, w, window, shift), device,
                     lambda: attn.shifted_window_mask(h, w, window, shift,
                                                      device=device))


def _effective_window(map_size: int, preferred: int) -> int:
    """Largest window <= MAX_WINDOW that divides the feature map (Swin-384
    uses window 12 where 7 does not divide the 96x96 stage-1 map)."""
    if map_size % preferred == 0:
        return preferred
    for w in range(min(MAX_WINDOW, map_size), 0, -1):
        if map_size % w == 0:
            return w
    return 1


def swin_block_init(gen, dim: int, n_heads: int, window: int,
                    mlp_ratio: float = 4.0, *, device=None,
                    dtype=torch.float32) -> Params:
    kw = dict(device=device, dtype=dtype)
    n_bias = (2 * max(window, MAX_WINDOW) - 1) ** 2
    return {
        "norm1": layernorm_init(dim, **kw),
        "attn": {name: linear_init(gen, dim, dim, **kw)
                 for name in ("wq", "wk", "wv", "wo")},
        "rel_bias": trunc_normal(gen, (n_bias, n_heads), **kw),
        "norm2": layernorm_init(dim, **kw),
        "mlp": mlp_init(gen, dim, int(dim * mlp_ratio), **kw),
    }


def swin_block(p: Params, x: torch.Tensor, *, n_heads: int, window: int,
               shift: int, rel_index: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, C]; rel_index [w^2, w^2] (_rel_position_index). On
    a mesh x enters laid out batch over the DP axes, the map whole (the
    windows are cut from it)."""
    x = constrain_spec(x, ("data", None, None, None))
    b, h, w, c = x.shape
    shortcut = x
    x = layernorm(p["norm1"], x)
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    wins = attn.window_partition(x, window)          # [B*nW, w^2, C]
    t = window * window
    rel_bias = p["rel_bias"][rel_index.reshape(-1)].reshape(t, t, -1)
    rel_bias = rel_bias.permute(2, 0, 1)             # [heads, T, T]
    mask = shift_mask(h, w, window, shift, x.device) if shift > 0 else None
    wins = attn.window_attention(p["attn"], wins, n_heads=n_heads,
                                 rel_bias=rel_bias, mask=mask)
    # windows sharded only as whole images are, so the map reassembles
    wins = constrain_spec(wins, (dp_entry(wins, b), None, None))
    # the map (and its gradient) laid out as at the block's entry
    x = constrain_spec(attn.window_unpartition(wins, window, h, w),
                       ("data", None, None, None))
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = shortcut + x
    return x + mlp(p["mlp"], layernorm(p["norm2"], x))


def patch_merge_init(gen, dim: int, *, device=None,
                     dtype=torch.float32) -> Params:
    return {"norm": layernorm_init(4 * dim, device=device, dtype=dtype),
            "reduce": linear_init(gen, 4 * dim, 2 * dim, bias=False,
                                  device=device, dtype=dtype)}


def patch_merge(p: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 2C]."""
    b, h, w, c = x.shape
    x = batch_rows(x).reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
    return linear(p["reduce"], layernorm(p["norm"], batch_rows(x)))


def _stage_heads(cfg: VisionConfig) -> list[int]:
    return [max(1, d // 32) for d in cfg.dims]


def swin_stages(stages: list, cfg: VisionConfig,
                x: torch.Tensor) -> list[torch.Tensor]:
    """x [B, H, W, C] after the patch norm -> each stage's output map
    (its blocks run, before its merge). Each stage's window is
    _effective_window of its map; odd blocks shift by half a window
    unless the map is no larger than the window."""
    heads = _stage_heads(cfg)
    outs = []
    for s, stage in enumerate(stages):
        for i, bp in enumerate(stage["blocks"]):
            eff_w = _effective_window(x.shape[1], cfg.window)
            shift = 0 if (i % 2 == 0 or x.shape[1] <= eff_w) else eff_w // 2
            x = swin_block(bp, x, n_heads=heads[s], window=eff_w,
                           shift=shift, rel_index=rel_index(eff_w, x.device))
        outs.append(x)
        if "merge" in stage:
            x = patch_merge(stage["merge"], x)
    return outs


def swin_stages_init(gen, cfg: VisionConfig, **kw) -> list:
    """Fresh stages from `gen`: each its blocks and, but the last, the
    merge into the next (kw: device, dtype)."""
    heads = _stage_heads(cfg)
    stages = []
    for s, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        stage = {"blocks": [swin_block_init(gen, dim, heads[s], cfg.window,
                                            **kw) for _ in range(depth)]}
        if s < len(cfg.depths) - 1:
            stage["merge"] = patch_merge_init(gen, dim, **kw)
        stages.append(stage)
    return stages


def swin_init(gen, cfg: VisionConfig, device=None) -> Params:
    """Fresh weights in cfg.dtype from `gen` (a torch.Generator, drawn on
    its device, or a numpy Generator), on `device` (the card unless the
    caller passes "cpu")."""
    if not cfg.swin:
        raise ValueError(f"{cfg.name} is not a Swin config")
    device = resolve_device(device)
    kw = dict(device=device, dtype=cfg.dtype)
    stages = swin_stages_init(gen, cfg, **kw)
    return {
        "patch_embed": conv_init(gen, cfg.patch, cfg.patch, 3, cfg.dims[0],
                                 **kw),
        "patch_norm": layernorm_init(cfg.dims[0], **kw),
        "stages": stages,
        "final_norm": layernorm_init(cfg.dims[-1], **kw),
        "head": linear_init(gen, cfg.dims[-1], cfg.n_classes, **kw),
    }


def swin_forward(params: Params, cfg: VisionConfig,
                 images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] -> logits [B, n_classes] (swin_stages, the
    last stage's map normed and pooled)."""
    pe = params["patch_embed"]
    wflat = pe["w"].to(cfg.dtype).reshape(-1, pe["w"].shape[-1])
    b, h, w, _ = images.shape
    x = patch_embed(images.to(cfg.dtype), wflat, pe["b"].to(cfg.dtype),
                    patch=cfg.patch)
    x = batch_rows(x.reshape(b, h // cfg.patch, w // cfg.patch, -1))
    x = layernorm(params["patch_norm"], x)
    x = swin_stages(params["stages"], cfg, x)[-1]
    x = layernorm(params["final_norm"], x)
    x = x.mean(dim=(1, 2))                           # global average pool
    return linear(params["head"], x)


def swin_loss(params: Params, cfg: VisionConfig, images: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    return classifier_nll(swin_forward(params, cfg, images), labels)
