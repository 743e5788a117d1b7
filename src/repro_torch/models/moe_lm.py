"""MoE decoder LM (DeepSeek-V3 / Kimi-K2): `first_dense_layers` dense
blocks (a list, unstacked) followed by MoE blocks stacked on a leading
axis. Attention is MLA (DeepSeek) or GQA (Kimi); `impl` reaches every
block's attention, as in the reference."""
from __future__ import annotations

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.devices import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.layers import (
    Params,
    embedding,
    embedding_init,
    layer_params,
    linear,
    linear_init,
    mlp,
    mlp_init,
    remat,
    rmsnorm,
    rmsnorm_init,
    stack_init,
)
from repro_torch.models.transformer import token_nll


def _attn_init(gen, cfg: LMConfig, device=None) -> Params:
    kw = dict(device=device, dtype=cfg.dtype)
    if cfg.mla:
        return attn.mla_init(gen, cfg.d_model, cfg.n_heads,
                             q_lora_rank=cfg.q_lora_rank,
                             kv_lora_rank=cfg.kv_lora_rank,
                             qk_nope_dim=cfg.qk_nope_dim,
                             qk_rope_dim=cfg.qk_rope_dim,
                             v_head_dim=cfg.v_head_dim, **kw)
    return attn.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.resolved_head_dim, **kw)


def mla_dims(cfg: LMConfig) -> dict:
    """The MLA attention functions' width arguments from a config."""
    return dict(n_heads=cfg.n_heads, qk_nope_dim=cfg.qk_nope_dim,
                qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim,
                kv_lora_rank=cfg.kv_lora_rank)


def attn_apply(p: Params, x: torch.Tensor, cfg: LMConfig, angles,
               impl: str) -> torch.Tensor:
    if cfg.mla:
        return attn.mla_attention(p, x, angles=angles, causal=True,
                                  impl=impl, **mla_dims(cfg))
    return attn.gqa_attention(p, x, n_heads=cfg.n_heads,
                              n_kv_heads=cfg.n_kv_heads, angles=angles,
                              causal=True, impl=impl)


def dense_block_init(gen, cfg: LMConfig, device=None) -> Params:
    kw = dict(device=device, dtype=cfg.dtype)
    return {
        "attn_norm": rmsnorm_init(cfg.d_model, **kw),
        "attn": _attn_init(gen, cfg, device),
        "mlp_norm": rmsnorm_init(cfg.d_model, **kw),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=True, bias=False,
                        **kw),
    }


def moe_block_init(gen, cfg: LMConfig, device=None) -> Params:
    kw = dict(device=device, dtype=cfg.dtype)
    return {
        "attn_norm": rmsnorm_init(cfg.d_model, **kw),
        "attn": _attn_init(gen, cfg, device),
        "mlp_norm": rmsnorm_init(cfg.d_model, **kw),
        "moe": moe.moe_init(gen, cfg, device),
    }


def n_moe_layers(cfg: LMConfig) -> int:
    return cfg.n_layers - cfg.first_dense_layers


def moe_lm_init(gen, cfg: LMConfig, device=None) -> Params:
    """Fresh weights in cfg.dtype (the routers float32) from `gen` (a
    torch.Generator or a numpy Generator), on `device` (the card unless
    the caller passes "cpu")."""
    device = resolve_device(device)
    kw = dict(device=device, dtype=cfg.dtype)
    return {
        "embed": embedding_init(gen, cfg.vocab, cfg.d_model, **kw),
        "dense_layers": [dense_block_init(gen, cfg, device)
                         for _ in range(cfg.first_dense_layers)],
        "moe_layers": stack_init(gen, n_moe_layers(cfg),
                                 lambda g: moe_block_init(g, cfg, device)),
        "final_norm": rmsnorm_init(cfg.d_model, **kw),
        "lm_head": linear_init(gen, cfg.d_model, cfg.vocab, bias=False,
                               **kw),
    }


def moe_lm_forward(params: Params, cfg: LMConfig, tokens: torch.Tensor, *,
                   impl: str = "xla", capacity_factor: float = 1.25):
    """tokens [B, S] -> (logits [B, S, V], aux_loss). With cfg.remat
    each MoE layer is recomputed in the backward pass (layers.remat), as
    the reference's; the dense layers are not."""
    s = tokens.shape[1]
    x = embedding(params["embed"], tokens)
    # MLA ropes qk_rope_dim dims of each head, GQA whole heads
    rope_dim = cfg.qk_rope_dim if cfg.mla else cfg.resolved_head_dim
    angles = attn.rope_frequencies(rope_dim, s, cfg.rope_theta,
                                   device=x.device)

    for lp in params["dense_layers"]:
        x = x + attn_apply(lp["attn"], rmsnorm(lp["attn_norm"], x), cfg,
                           angles, impl)
        x = x + mlp(lp["mlp"], rmsnorm(lp["mlp_norm"], x))

    def moe_block(lp, x, aux):
        x = x + attn_apply(lp["attn"], rmsnorm(lp["attn_norm"], x), cfg,
                           angles, impl)
        y, m = moe.moe_ffn(lp["moe"], rmsnorm(lp["mlp_norm"], x), cfg,
                           capacity_factor=capacity_factor)
        return x + y, aux + m.aux_loss

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_moe_layers(cfg)):
        x, aux = remat(cfg.remat, moe_block,
                       layer_params(params["moe_layers"], i), x, aux)
    x = rmsnorm(params["final_norm"], x)
    return linear(params["lm_head"], x), aux / max(1, n_moe_layers(cfg))


def moe_lm_loss(params: Params, cfg: LMConfig, tokens, labels, *,
                aux_weight: float = 0.001) -> torch.Tensor:
    logits, aux = moe_lm_forward(params, cfg, tokens)
    return token_nll(logits, labels) + aux_weight * aux
