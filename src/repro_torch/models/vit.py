"""ViT encoder (ViT-S/16, B/16, H/14, and the detector's backbone) with
its conv patch-embed and classification head.

Every entry takes one of two forms: the reference's, with a
VisionConfig (`vit_forward(params, cfg, images, impl=...)`), which runs
in cfg.dtype (images cast to it before the patch-embed, as the
reference's); or the detector's keywords (`vit_forward(params, images,
patch=..., n_heads=..., impl=...)`), float32.

On the detector's main path the patch-embed is fused into
kernels/crop_patchify, so the encoder starts from tokens [B, P, D]
(`vit_encode_tokens`, `vit_features_tokens`); `vit_embed` is the conv
patch-embed on its own, for images. Layer parameters are stacked with a
leading [n_layers] axis, as in the reference checkpoints. Every encoder
entry takes `impl` ("xla" by default, or "flash": the flash-attention
kernel in every layer), as the reference's do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import VisionConfig
from repro_torch.devices import resolve_device
from repro_torch.models.attention import gqa_attention, gqa_init
from repro_torch.models.layers import (
    Params,
    constrain_spec,
    conv_init,
    grid_side,
    layer_params,
    layernorm,
    layernorm_init,
    linear,
    linear_init,
    mlp,
    mlp_init,
    params_from_numpy,
    patch_embed,
    remat,
    resize_grid,
    stack_init,
    trunc_normal,
)


def _form(args, patch, n_heads):
    """(x, patch, n_heads, dtype) of either call form: (cfg, x), or (x,)
    with the keywords (float32)."""
    if isinstance(args[0], VisionConfig):
        cfg, x = args
        return x, cfg.patch, cfg.n_heads, cfg.dtype
    (x,) = args
    if patch is None or n_heads is None:
        raise TypeError("pass a VisionConfig, or patch= and n_heads=")
    return x, patch, n_heads, torch.float32


def _block_init(gen, d_model, n_heads, d_ff, device, dtype) -> Params:
    kw = dict(device=device, dtype=dtype)
    return {"norm1": layernorm_init(d_model, **kw),
            "attn": gqa_init(gen, d_model, n_heads, n_heads, bias=True, **kw),
            "norm2": layernorm_init(d_model, **kw),
            "mlp": mlp_init(gen, d_model, d_ff, bias=True, **kw)}


def vit_block_init(gen, cfg: VisionConfig, device=None) -> Params:
    """One encoder layer's parameters in cfg.dtype."""
    return _block_init(gen, cfg.d_model, cfg.n_heads, cfg.d_ff,
                       resolve_device(device), cfg.dtype)


def vit_init(gen, cfg: VisionConfig | None = None, *,
             img_res: int | None = None, patch: int | None = None,
             n_layers: int | None = None, d_model: int | None = None,
             n_heads: int | None = None, d_ff: int | None = None,
             n_classes: int = 2, device=None) -> Params:
    """Fresh weights from `gen` (a torch.Generator, drawn on its device,
    or a numpy Generator). With a VisionConfig: its widths in cfg.dtype,
    pos_embed for `img_res` (cfg.img_res by default), on `device` (the
    card unless the caller passes "cpu"). Without: the keywords, float32,
    on `device` as given (the detector's backbone)."""
    if cfg is not None:
        img_res = img_res or cfg.img_res
        patch, n_layers, d_model = cfg.patch, cfg.n_layers, cfg.d_model
        n_heads, d_ff, n_classes = cfg.n_heads, cfg.d_ff, cfg.n_classes
        device, dtype = resolve_device(device), cfg.dtype
    else:
        dtype = torch.float32
    n_patches = (img_res // patch) ** 2
    kw = dict(device=device, dtype=dtype)
    return {
        "patch_embed": conv_init(gen, patch, patch, 3, d_model, **kw),
        "cls_token": trunc_normal(gen, (1, 1, d_model), **kw),
        "pos_embed": trunc_normal(gen, (1, n_patches + 1, d_model), **kw),
        "layers": stack_init(gen, n_layers, lambda g: _block_init(
            g, d_model, n_heads, d_ff, device, dtype)),
        "final_norm": layernorm_init(d_model, **kw),
        "head": linear_init(gen, d_model, n_classes, **kw),
    }


def vision_params_from_numpy(tree, dtype, device=None) -> Params:
    """The reference's ViT or Swin parameters (as `vit_init` /
    `swin_init` in the JAX package make them, numpy or JAX arrays) -> the
    port's tree on `device` (the card unless the caller passes "cpu"),
    floating leaves in `dtype`; stacked ViT layers and Swin's per-stage
    block lists keep the reference's layout."""
    return params_from_numpy(tree, dtype, device)


def vit_block(p: Params, x: torch.Tensor, n_heads: int,
              impl: str = "xla") -> torch.Tensor:
    """On a mesh x enters laid out batch over the DP axes."""
    x = constrain_spec(x, ("data", None, None))
    x = x + gqa_attention(p["attn"], layernorm(p["norm1"], x),
                          n_heads=n_heads, n_kv_heads=n_heads, causal=False,
                          impl=impl)
    return x + mlp(p["mlp"], layernorm(p["norm2"], x))


def _interp_pos_embed(pos: torch.Tensor, n_patches: int) -> torch.Tensor:
    """Bilinear-resize the grid part of pos_embed [1, 1+P, D] to a new
    square patch count (layers.resize_grid); the CLS entry is kept."""
    if pos.shape[1] - 1 == n_patches:
        return pos
    g_new = grid_side(n_patches, "tokens")
    return torch.cat([pos[:, :1], resize_grid(pos[:, 1:], g_new)], dim=1)


def vit_embed(params: Params, *args,
              patch: int | None = None) -> torch.Tensor:
    """images [B, H, W, 3] -> patch-embedding tokens [B, P, D] (no CLS):
    the conv patch-embed that crop_patchify fuses on the main path,
    computed as the plain crop -> token stage computes it
    (layers.patch_embed), in the form's dtype."""
    images, patch, _, dtype = _form(args, patch, 0)
    pe = params["patch_embed"]
    w = pe["w"].to(dtype)
    b = pe.get("b")
    return patch_embed(images.to(dtype), w.reshape(-1, w.shape[-1]),
                       None if b is None else b.to(dtype), patch=patch)


def vit_encode_tokens(params: Params, *args, n_heads: int | None = None,
                      impl: str = "xla") -> torch.Tensor:
    """patch tokens [B, P, D] -> encoded tokens [B, 1+P, D] (CLS first);
    pos_embed is resized when it holds another patch count. A
    VisionConfig with remat recomputes each layer in the backward pass
    (layers.remat)."""
    x, _, n_heads, _ = _form(args, 0, n_heads)
    recompute = isinstance(args[0], VisionConfig) and args[0].remat
    b, n_patches, d = x.shape
    cls = params["cls_token"].to(x.dtype).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1)
    x = x + _interp_pos_embed(params["pos_embed"], n_patches).to(x.dtype)
    n_layers = params["layers"]["norm1"]["scale"].shape[0]
    for i in range(n_layers):
        x = remat(recompute, vit_block, layer_params(params["layers"], i), x,
                  n_heads, impl)
    return layernorm(params["final_norm"], x)


def vit_features_tokens(params: Params, *args, n_heads: int | None = None,
                        impl: str = "xla") -> torch.Tensor:
    """patch tokens [B, P, D] (square P) -> feature map [B, g, g, D]."""
    tokens = _form(args, 0, n_heads)[0]
    b, n_patches, d = tokens.shape
    g = grid_side(n_patches, "tokens")
    x = vit_encode_tokens(params, *args, n_heads=n_heads, impl=impl)
    return x[:, 1:].reshape(b, g, g, d)


def vit_encode(params: Params, *args, patch: int | None = None,
               n_heads: int | None = None,
               impl: str = "xla") -> torch.Tensor:
    """images [B, H, W, 3] -> tokens [B, 1+P, D] (CLS first)."""
    tokens = vit_embed(params, *args, patch=patch)     # (cfg,) images
    return vit_encode_tokens(params, *args[:-1], tokens,
                             n_heads=n_heads, impl=impl)


def vit_features(params: Params, *args, patch: int | None = None,
                 n_heads: int | None = None,
                 impl: str = "xla") -> torch.Tensor:
    """images [B, H, W, 3] -> patch feature map [B, h, w, D] (no CLS)."""
    tokens = vit_embed(params, *args, patch=patch)
    return vit_features_tokens(params, *args[:-1], tokens,
                               n_heads=n_heads, impl=impl)


def vit_forward(params: Params, *args, patch: int | None = None,
                n_heads: int | None = None,
                impl: str = "xla") -> torch.Tensor:
    """images [B, H, W, 3] -> class logits [B, n_classes]."""
    tokens = vit_encode(params, *args, patch=patch, n_heads=n_heads,
                        impl=impl)
    return linear(params["head"], tokens[:, 0])


def classifier_nll(logits: torch.Tensor, labels: torch.Tensor,
                   label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy of labels [B] under logits [B, n] in float32,
    against one-hot targets smoothed toward uniform by
    `label_smoothing`."""
    logp = F.log_softmax(logits.float(), dim=-1)
    n = logits.shape[-1]
    onehot = F.one_hot(labels.long(), n).float()
    if label_smoothing > 0:
        onehot = onehot * (1 - label_smoothing) + label_smoothing / n
    return -(onehot * logp).sum(-1).mean()


def vit_loss(params: Params, cfg: VisionConfig, images: torch.Tensor,
             labels: torch.Tensor, *,
             label_smoothing: float = 0.0) -> torch.Tensor:
    """Classification loss of the plain ("xla") forward, as the
    reference's."""
    return classifier_nll(vit_forward(params, cfg, images), labels,
                          label_smoothing)
