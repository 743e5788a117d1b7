"""ViT encoder (the detector's backbone) with its conv patch-embed.

On the detector's main path the patch-embed is fused into
kernels/crop_patchify, so the encoder starts from tokens [B, P, D]
(`vit_encode_tokens`, `vit_features_tokens`); `vit_embed` is the conv
patch-embed on its own, for images. Layer parameters are stacked with a
leading [n_layers] axis, as in the reference checkpoints. Every encoder
entry takes `impl` ("xla" by default, or "flash": the flash-attention
kernel), as the reference's do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import gqa_attention, gqa_init
from repro_torch.models.layers import (
    Params,
    conv_init,
    layer_params,
    layernorm,
    layernorm_init,
    linear,
    linear_init,
    mlp,
    patch_embed,
    stack_init,
    trunc_normal,
)


def vit_init(gen, *, img_res: int, patch: int, n_layers: int,
             d_model: int, n_heads: int, d_ff: int, n_classes: int = 2,
             device=None) -> Params:
    n_patches = (img_res // patch) ** 2

    def block():
        return {"norm1": layernorm_init(d_model, device=device),
                "attn": gqa_init(gen, d_model, n_heads, n_heads, bias=True,
                                 device=device),
                "norm2": layernorm_init(d_model, device=device),
                "mlp": {"up": linear_init(gen, d_model, d_ff,
                                          device=device),
                        "down": linear_init(gen, d_ff, d_model,
                                            device=device)}}

    return {
        "patch_embed": conv_init(gen, patch, patch, 3, d_model,
                                 device=device),
        "cls_token": trunc_normal(gen, (1, 1, d_model), device=device),
        "pos_embed": trunc_normal(gen, (1, n_patches + 1, d_model),
                                  device=device),
        "layers": stack_init(gen, n_layers, lambda _: block()),
        "final_norm": layernorm_init(d_model, device=device),
        "head": linear_init(gen, d_model, n_classes, device=device),
    }


def vit_block(p: Params, x: torch.Tensor, n_heads: int,
              impl: str = "xla") -> torch.Tensor:
    x = x + gqa_attention(p["attn"], layernorm(p["norm1"], x),
                          n_heads=n_heads, n_kv_heads=n_heads, causal=False,
                          impl=impl)
    return x + mlp(p["mlp"], layernorm(p["norm2"], x))


def _grid_side(n: int, what: str) -> int:
    g = int(round(n ** 0.5))
    if g * g != n:
        raise ValueError(f"{what}: {n} patches do not form a square grid")
    return g


def _interp_pos_embed(pos: torch.Tensor, n_patches: int) -> torch.Tensor:
    """Bilinear-resize the grid part of pos_embed [1, 1+P, D] to a new
    square patch count (antialiased when it shrinks, as
    jax.image.resize's "bilinear" is); the CLS entry is kept."""
    n_old = pos.shape[1] - 1
    if n_old == n_patches:
        return pos
    g_old = _grid_side(n_old, "pos_embed")
    g_new = _grid_side(n_patches, "tokens")
    cls, grid = pos[:, :1], pos[:, 1:]
    grid = grid.reshape(1, g_old, g_old, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid.float(), size=(g_new, g_new), mode="bilinear",
                         align_corners=False, antialias=True).to(pos.dtype)
    grid = grid.permute(0, 2, 3, 1).reshape(1, g_new * g_new, -1)
    return torch.cat([cls, grid], dim=1)


def vit_embed(params: Params, images: torch.Tensor, *,
              patch: int) -> torch.Tensor:
    """images [B, H, W, 3] -> patch-embedding tokens [B, P, D] (no CLS):
    the conv patch-embed that crop_patchify fuses on the main path,
    computed as the plain crop -> token stage computes it
    (layers.patch_embed)."""
    pe = params["patch_embed"]
    w = pe["w"]
    return patch_embed(images.float(), w.reshape(-1, w.shape[-1]),
                       pe.get("b"), patch=patch)


def vit_encode_tokens(params: Params, x: torch.Tensor, *, n_heads: int,
                      impl: str = "xla") -> torch.Tensor:
    """patch tokens [B, P, D] -> encoded tokens [B, 1+P, D] (CLS first);
    pos_embed is resized when it holds another patch count."""
    b, n_patches, d = x.shape
    cls = params["cls_token"].to(x.dtype).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1)
    x = x + _interp_pos_embed(params["pos_embed"], n_patches).to(x.dtype)
    n_layers = params["layers"]["norm1"]["scale"].shape[0]
    for i in range(n_layers):
        x = vit_block(layer_params(params["layers"], i), x, n_heads, impl)
    return layernorm(params["final_norm"], x)


def vit_features_tokens(params: Params, tokens: torch.Tensor, *,
                        n_heads: int, impl: str = "xla") -> torch.Tensor:
    """patch tokens [B, P, D] (square P) -> feature map [B, g, g, D]."""
    b, n_patches, d = tokens.shape
    g = _grid_side(n_patches, "tokens")
    x = vit_encode_tokens(params, tokens, n_heads=n_heads, impl=impl)
    return x[:, 1:].reshape(b, g, g, d)


def vit_encode(params: Params, images: torch.Tensor, *, patch: int,
               n_heads: int, impl: str = "xla") -> torch.Tensor:
    """images [B, H, W, 3] -> tokens [B, 1+P, D] (CLS first)."""
    return vit_encode_tokens(params, vit_embed(params, images, patch=patch),
                             n_heads=n_heads, impl=impl)


def vit_features(params: Params, images: torch.Tensor, *, patch: int,
                 n_heads: int, impl: str = "xla") -> torch.Tensor:
    """images [B, H, W, 3] -> patch feature map [B, h, w, D] (no CLS)."""
    return vit_features_tokens(params,
                               vit_embed(params, images, patch=patch),
                               n_heads=n_heads, impl=impl)


def vit_forward(params: Params, images: torch.Tensor, *, patch: int,
                n_heads: int, impl: str = "xla") -> torch.Tensor:
    """images [B, H, W, 3] -> class logits [B, n_classes]."""
    tokens = vit_encode(params, images, patch=patch, n_heads=n_heads,
                        impl=impl)
    return linear(params["head"], tokens[:, 0])
