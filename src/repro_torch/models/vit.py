"""ViT encoder over patch-embedding tokens (the detector's backbone).

The conv patch-embed itself is fused into kernels/crop_patchify, so the
encoder starts from tokens [B, P, D]. Layer parameters are stacked with
a leading [n_layers] axis, as in the reference checkpoints.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import attention, mha_init
from repro_torch.models.layers import (
    Params,
    conv_init,
    layernorm,
    layernorm_init,
    linear_init,
    mlp,
    trunc_normal,
)


def vit_init(gen, *, img_res: int, patch: int, n_layers: int,
             d_model: int, n_heads: int, d_ff: int, n_classes: int = 2,
             device=None) -> Params:
    n_patches = (img_res // patch) ** 2

    def block():
        return {"norm1": layernorm_init(d_model, device=device),
                "attn": mha_init(gen, d_model, n_heads, device=device),
                "norm2": layernorm_init(d_model, device=device),
                "mlp": {"up": linear_init(gen, d_model, d_ff,
                                          device=device),
                        "down": linear_init(gen, d_ff, d_model,
                                            device=device)}}

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    return {
        "patch_embed": conv_init(gen, patch, patch, 3, d_model,
                                 device=device),
        "cls_token": trunc_normal(gen, (1, 1, d_model), device=device),
        "pos_embed": trunc_normal(gen, (1, n_patches + 1, d_model),
                                  device=device),
        "layers": stack([block() for _ in range(n_layers)]),
        "final_norm": layernorm_init(d_model, device=device),
        "head": linear_init(gen, d_model, n_classes, device=device),
    }


def _layer(layers: Params, i: int) -> Params:
    if isinstance(layers, dict):
        return {k: _layer(v, i) for k, v in layers.items()}
    return layers[i]


def vit_block(p: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    x = x + attention(p["attn"], layernorm(p["norm1"], x), n_heads=n_heads)
    return x + mlp(p["mlp"], layernorm(p["norm2"], x))


def vit_encode_tokens(params: Params, x: torch.Tensor, *,
                      n_heads: int) -> torch.Tensor:
    """patch tokens [B, P, D] -> encoded tokens [B, 1+P, D] (CLS first)."""
    b, n_patches, d = x.shape
    pos = params["pos_embed"]
    if pos.shape[1] - 1 != n_patches:
        raise NotImplementedError(
            f"pos_embed holds {pos.shape[1] - 1} patches, the tokens "
            f"{n_patches}: resizing the position embedding is not ported")
    cls = params["cls_token"].expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + pos
    n_layers = params["layers"]["norm1"]["scale"].shape[0]
    for i in range(n_layers):
        x = vit_block(_layer(params["layers"], i), x, n_heads)
    return layernorm(params["final_norm"], x)


def vit_features_tokens(params: Params, tokens: torch.Tensor, *,
                        n_heads: int) -> torch.Tensor:
    """patch tokens [B, P, D] (square P) -> feature map [B, g, g, D]."""
    b, n_patches, d = tokens.shape
    g = int(round(n_patches ** 0.5))
    x = vit_encode_tokens(params, tokens, n_heads=n_heads)
    return x[:, 1:].reshape(b, g, g, d)
