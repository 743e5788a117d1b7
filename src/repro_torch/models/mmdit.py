"""Flux-dev style MMDiT: double-stream then single-stream blocks, as
functions on the reference's parameter dictionaries (blocks stacked on a
leading axis per family, run in a loop).

Double blocks: the image and text streams each have their own QKV, MLP
and adaLN modulation; attention runs over the concatenated sequence.
Single blocks: one fused stream with attention and MLP in parallel.
Text conditioning is a stub input (precomputed embeddings [B, T_txt,
cond_dim]), as in the reference. Attention is the plain path and the
q/k RMSNorm the plain rmsnorm, as the reference's are.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import DiffusionConfig
from repro_torch.devices import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.dit import (
    ada_init,
    final_layer,
    time_condition,
    unpatchify,
)
from repro_torch.models.layers import (
    Params,
    batch_rows,
    constrain_spec,
    gelu,
    layer_params,
    linear,
    linear_init,
    modulated_layernorm,
    remat,
    rmsnorm,
    rmsnorm_init,
    silu,
    stack_init,
)

TXT_TOKENS = 128  # stub text-sequence length


def _qkv_init(gen, d: int, **kw) -> Params:
    p = {name: linear_init(gen, d, d, bias=True, **kw)
         for name in ("wq", "wk", "wv", "wo")}
    p["q_norm"] = rmsnorm_init(d, **kw)
    p["k_norm"] = rmsnorm_init(d, **kw)
    return p


def _mlp_init(gen, d: int, **kw) -> Params:
    return {"up": linear_init(gen, d, 4 * d, bias=True, **kw),
            "down": linear_init(gen, 4 * d, d, bias=True, **kw)}


def double_block_init(gen, cfg: DiffusionConfig, device=None) -> Params:
    kw = dict(device=device, dtype=cfg.dtype)
    d = cfg.d_model
    return {
        "img_attn": _qkv_init(gen, d, **kw),
        "txt_attn": _qkv_init(gen, d, **kw),
        "img_mlp": _mlp_init(gen, d, **kw),
        "txt_mlp": _mlp_init(gen, d, **kw),
        "img_ada": ada_init(d, 6 * d, **kw),
        "txt_ada": ada_init(d, 6 * d, **kw),
    }


def single_block_init(gen, cfg: DiffusionConfig, device=None) -> Params:
    kw = dict(device=device, dtype=cfg.dtype)
    d = cfg.d_model
    return {
        "attn": _qkv_init(gen, d, **kw),
        "mlp": _mlp_init(gen, d, **kw),
        "ada": ada_init(d, 3 * d, **kw),
    }


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    return attn.split_heads(x, n_heads)


def sincos_2d(g: int, dim: int, dtype=torch.float32,
              device=None) -> torch.Tensor:
    """[1, g*g, dim] fixed axial sin-cos position embedding (Flux encodes
    position with RoPE; the reference's parameter-free stand-in)."""
    half = dim // 2
    n = half // 2
    freqs = 1.0 / (10000.0 ** (torch.arange(n, dtype=torch.float32,
                                            device=device) / max(n, 1)))
    r = torch.arange(g, dtype=torch.float32, device=device)
    ys, xs = torch.meshgrid(r, r, indexing="ij")

    def axis(v):
        a = v.reshape(-1)[:, None] * freqs[None]
        return torch.cat([torch.sin(a), torch.cos(a)], dim=-1)

    emb = torch.cat([axis(ys), axis(xs)], dim=-1)
    if emb.shape[-1] < dim:
        emb = torch.nn.functional.pad(emb, (0, dim - emb.shape[-1]))
    return emb[None].to(dtype)


_QKV_SPEC = ("data", None, "model")


def _qkv(p: Params, h: torch.Tensor):
    """q, k, v [B, T, D] of one stream, q and k RMS-normalized over D
    (on a mesh: batch over the DP axes, D over `model`)."""
    q = rmsnorm(p["q_norm"], linear(p["wq"], h))
    k = rmsnorm(p["k_norm"], linear(p["wk"], h))
    return tuple(constrain_spec(t, _QKV_SPEC)
                 for t in (q, k, linear(p["wv"], h)))


def _mlp(p: Params, h: torch.Tensor) -> torch.Tensor:
    return linear(p["down"], gelu(linear(p["up"], h)))


def double_block(p: Params, img: torch.Tensor, txt: torch.Tensor,
                 c: torch.Tensor, cfg: DiffusionConfig):
    """img [B, Ti, D], txt [B, Tt, D], c [B, D] -> (img', txt')."""
    h = cfg.n_heads
    im = linear(p["img_ada"], silu(c))[:, None, :]
    tm = linear(p["txt_ada"], silu(c))[:, None, :]
    ish1, isc1, ig1, ish2, isc2, ig2 = im.chunk(6, dim=-1)
    tsh1, tsc1, tg1, tsh2, tsc2, tg2 = tm.chunk(6, dim=-1)
    qi, ki, vi = _qkv(p["img_attn"], modulated_layernorm({}, img, ish1,
                                                         isc1))
    qt, kt, vt = _qkv(p["txt_attn"], modulated_layernorm({}, txt, tsh1,
                                                         tsc1))
    tt = txt.shape[1]
    o = attn.sdpa(_heads(torch.cat([qt, qi], 1), h),
                  _heads(torch.cat([kt, ki], 1), h),
                  _heads(torch.cat([vt, vi], 1), h), causal=False)
    o = attn.merge_heads(o)
    ot, oi = o[:, :tt], o[:, tt:]
    img = img + ig1 * linear(p["img_attn"]["wo"], oi)
    txt = txt + tg1 * linear(p["txt_attn"]["wo"], ot)
    img = img + ig2 * _mlp(p["img_mlp"],
                           modulated_layernorm({}, img, ish2, isc2))
    txt = txt + tg2 * _mlp(p["txt_mlp"],
                           modulated_layernorm({}, txt, tsh2, tsc2))
    return img, txt


def single_block(p: Params, x: torch.Tensor, c: torch.Tensor,
                 cfg: DiffusionConfig) -> torch.Tensor:
    """Fused stream [B, T, D]: attention and MLP in parallel."""
    h_ = cfg.n_heads
    mod = linear(p["ada"], silu(c))[:, None, :]
    sh, sc, g = mod.chunk(3, dim=-1)
    h = modulated_layernorm({}, x, sh, sc)
    q, k, v = _qkv(p["attn"], h)
    o = attn.sdpa(_heads(q, h_), _heads(k, h_), _heads(v, h_), causal=False)
    o = linear(p["attn"]["wo"], attn.merge_heads(o))
    return x + g * (o + _mlp(p["mlp"], h))


def mmdit_init(gen, cfg: DiffusionConfig, device=None) -> Params:
    """Fresh weights in cfg.dtype from `gen` (a torch.Generator, drawn on
    its device, or a numpy Generator), on `device` (the card unless the
    caller passes "cpu"). The adaLN linears and the final projection
    start at zero, as the reference's."""
    device = resolve_device(device)
    kw = dict(device=device, dtype=cfg.dtype)
    d, c = cfg.d_model, cfg.latent_channels
    pp = cfg.patch * cfg.patch * c
    return {
        "img_in": linear_init(gen, pp, d, **kw),
        "txt_in": linear_init(gen, cfg.cond_dim, d, **kw),
        "t_mlp": {"fc1": linear_init(gen, 256, d, **kw),
                  "fc2": linear_init(gen, d, d, **kw)},
        "double": stack_init(gen, cfg.n_double_blocks,
                             lambda g: double_block_init(g, cfg, device)),
        "single": stack_init(gen, cfg.n_single_blocks,
                             lambda g: single_block_init(g, cfg, device)),
        "final_ada": ada_init(d, 2 * d, **kw),
        "final_proj": linear_init(gen, d, pp, std=0.0, **kw),
    }


def mmdit_forward(params: Params, cfg: DiffusionConfig,
                  latents: torch.Tensor, t: torch.Tensor,
                  txt_emb: torch.Tensor) -> torch.Tensor:
    """latents [B, R, R, C]; t [B] in [0, 1]; txt_emb [B, T_txt,
    cond_dim] -> velocity [B, R, R, C] in cfg.dtype."""
    b, r, _, c = latents.shape
    p_sz = cfg.patch
    g = r // p_sz
    x = batch_rows(latents).reshape(b, g, p_sz, g, p_sz, c).permute(
        0, 1, 3, 2, 4, 5)
    x = x.reshape(b, g * g, p_sz * p_sz * c)
    img = linear(params["img_in"], x.to(cfg.dtype))
    img = img + sincos_2d(g, cfg.d_model, img.dtype, img.device)
    txt = linear(params["txt_in"], txt_emb.to(cfg.dtype))
    cond = time_condition(params, cfg.dtype, t * 1000.0)
    for i in range(params["double"]["img_ada"]["w"].shape[0]):
        img, txt = remat(cfg.remat, double_block,
                         layer_params(params["double"], i), img, txt, cond,
                         cfg)
    fused = torch.cat([txt, img], dim=1)
    for i in range(params["single"]["ada"]["w"].shape[0]):
        fused = remat(cfg.remat, single_block,
                      layer_params(params["single"], i), fused, cond, cfg)
    img = fused[:, txt.shape[1]:]
    return unpatchify(final_layer(params, img, cond), g, p_sz, c)
