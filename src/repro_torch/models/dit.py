"""DiT-L/2 (adaLN-zero; Peebles & Xie, arXiv:2212.09748) as functions
on the reference's parameter dictionaries.

Operates on latents [B, latent_res, latent_res, C] (latent_res =
img_res / 8 for a stub VAE). Conditioning is the timestep and class
label embeddings (adaLN-zero modulation). Layers are stacked on a
leading [n_layers] axis, as in the reference, and run in a loop;
attention is the plain path, as the reference's is.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import DiffusionConfig
from repro_torch.devices import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    Params,
    batch_rows,
    constrain_spec,
    conv_init,
    layer_params,
    linear,
    linear_init,
    mlp,
    mlp_init,
    modulated_layernorm,
    patch_embed,
    remat,
    resize_grid,
    silu,
    stack_init,
    trunc_normal,
)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """t [B] (float timesteps) -> [B, dim] sinusoidal embedding, float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def ada_init(d_in: int, d_out: int, *, device=None,
             dtype=torch.float32) -> Params:
    """An adaLN-zero modulation linear: zero weights and bias."""
    return {"w": torch.zeros(d_in, d_out, device=device, dtype=dtype),
            "b": torch.zeros(d_out, device=device, dtype=dtype)}


def dit_block_init(gen, cfg: DiffusionConfig, device=None) -> Params:
    kw = dict(device=device, dtype=cfg.dtype)
    d = cfg.d_model
    return {
        "attn": attn.gqa_init(gen, d, cfg.n_heads, cfg.n_heads, bias=True,
                              **kw),
        "mlp": mlp_init(gen, d, 4 * d, **kw),
        "ada": ada_init(d, 6 * d, **kw),
    }


def dit_block(p: Params, x: torch.Tensor, c: torch.Tensor,
              cfg: DiffusionConfig) -> torch.Tensor:
    """x [B, T, D]; c [B, D] conditioning. On a mesh x enters laid out
    batch over the DP axes."""
    x = constrain_spec(x, ("data", None, None))
    mod = linear(p["ada"], silu(c))[:, None, :]        # [B, 1, 6D]
    sh1, sc1, g1, sh2, sc2, g2 = mod.chunk(6, dim=-1)
    h = modulated_layernorm({}, x, sh1, sc1)
    h = attn.gqa_attention(p["attn"], h, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_heads, causal=False)
    x = x + g1 * h
    h = modulated_layernorm({}, x, sh2, sc2)
    return x + g2 * mlp(p["mlp"], h)


def dit_init(gen, cfg: DiffusionConfig, device=None) -> Params:
    """Fresh weights in cfg.dtype from `gen` (a torch.Generator, drawn on
    its device, or a numpy Generator), on `device` (the card unless the
    caller passes "cpu"). The adaLN linears and the final projection
    start at zero (adaLN-zero), as the reference's."""
    device = resolve_device(device)
    kw = dict(device=device, dtype=cfg.dtype)
    latent_res = cfg.latent_res or cfg.img_res // 8
    n_tokens = (latent_res // cfg.patch) ** 2
    d, c = cfg.d_model, cfg.latent_channels
    return {
        "patch_embed": conv_init(gen, cfg.patch, cfg.patch, c, d, **kw),
        "pos_embed": trunc_normal(gen, (1, n_tokens, d), **kw),
        "t_mlp": {"fc1": linear_init(gen, 256, d, **kw),
                  "fc2": linear_init(gen, d, d, **kw)},
        # +1: the classifier-free guidance's null class
        "y_embed": trunc_normal(gen, (cfg.n_classes + 1, d), **kw),
        "layers": stack_init(gen, cfg.n_layers,
                             lambda g: dit_block_init(g, cfg, device)),
        "final_ada": ada_init(d, 2 * d, **kw),
        "final_proj": linear_init(gen, d, cfg.patch * cfg.patch * c,
                                  std=0.0, **kw),
    }


def time_condition(params: Params, dtype, t: torch.Tensor) -> torch.Tensor:
    """t [B] float timesteps -> [B, D]: the sinusoidal embedding through
    the t_mlp (fc1, silu, fc2), in `dtype`."""
    t_emb = timestep_embedding(t, 256).to(dtype)
    return linear(params["t_mlp"]["fc2"],
                  silu(linear(params["t_mlp"]["fc1"], t_emb)))


def unpatchify(x: torch.Tensor, g: int, patch: int, c: int) -> torch.Tensor:
    """[B, g*g, p*p*C] -> [B, g*p, g*p, C]."""
    b = x.shape[0]
    x = batch_rows(x).reshape(b, g, g, patch, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, g * patch, g * patch, c)


def final_layer(params: Params, x: torch.Tensor,
                c: torch.Tensor) -> torch.Tensor:
    """adaLN (final_ada from c) then final_proj: [B, T, D] -> [B, T,
    p*p*C]."""
    mod = linear(params["final_ada"], silu(c))[:, None, :]
    sh, sc = mod.chunk(2, dim=-1)
    return linear(params["final_proj"], modulated_layernorm({}, x, sh, sc))


def dit_forward(params: Params, cfg: DiffusionConfig, latents: torch.Tensor,
                t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """latents [B, R, R, C]; t [B] in [0, 1000); y [B] class ids -> noise
    prediction [B, R, R, C] in cfg.dtype. Off the trained grid, the
    learned pos_embed is resized bilinearly (layers.resize_grid)."""
    b, r, _, c = latents.shape
    p_sz = cfg.patch
    g = r // p_sz
    pe = params["patch_embed"]
    x = patch_embed(latents.to(cfg.dtype),
                    pe["w"].to(cfg.dtype).reshape(-1, cfg.d_model),
                    pe["b"].to(cfg.dtype), patch=p_sz)
    pos = params["pos_embed"]
    if pos.shape[1] != g * g:
        pos = resize_grid(pos, g)
    x = x + pos.to(x.dtype)
    cond = time_condition(params, cfg.dtype, t)
    cond = cond + params["y_embed"][y].to(cond.dtype)
    for i in range(params["layers"]["ada"]["w"].shape[0]):
        x = remat(cfg.remat, dit_block, layer_params(params["layers"], i),
                  x, cond, cfg)
    return unpatchify(final_layer(params, x, cond), g, p_sz, c)
