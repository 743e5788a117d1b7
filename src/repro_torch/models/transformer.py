"""Dense decoder-only LM (the StableLM family) as functions on the
reference's parameter dictionaries. Layers are stacked on a leading
[n_layers] axis, as in the reference's checkpoints, and run in a loop.

One departure from the reference: `lm_forward` passes `impl` on to
every block (the reference's `lm_forward` takes `impl` but runs its
blocks with "xla"). At the default impl="xla" both compute the same
thing; impl="flash" runs each layer's attention through the
flash-attention kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.devices import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    Params,
    embedding,
    embedding_init,
    layer_params,
    linear,
    linear_init,
    mlp,
    mlp_init,
    params_from_numpy,
    remat,
    rmsnorm,
    rmsnorm_init,
    stack_init,
)


def dense_block_init(gen, cfg: LMConfig, device=None) -> Params:
    kw = dict(device=device, dtype=cfg.dtype)
    return {
        "attn_norm": rmsnorm_init(cfg.d_model, **kw),
        "attn": attn.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.resolved_head_dim, **kw),
        "mlp_norm": rmsnorm_init(cfg.d_model, **kw),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=True, bias=False,
                        **kw),
    }


def dense_block(p: Params, x: torch.Tensor, cfg: LMConfig,
                angles: torch.Tensor, impl: str) -> torch.Tensor:
    h = attn.gqa_attention(p["attn"], rmsnorm(p["attn_norm"], x),
                           n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                           angles=angles, causal=True, impl=impl)
    x = x + h
    return x + mlp(p["mlp"], rmsnorm(p["mlp_norm"], x))


def lm_init(gen, cfg: LMConfig, device=None) -> Params:
    """Fresh weights in cfg.dtype from `gen` (a torch.Generator, drawn on
    its device, or a numpy Generator), on `device` (the card unless the
    caller passes "cpu")."""
    device = resolve_device(device)
    kw = dict(device=device, dtype=cfg.dtype)
    params = {
        "embed": embedding_init(gen, cfg.vocab, cfg.d_model, **kw),
        "layers": stack_init(gen, cfg.n_layers,
                             lambda g: dense_block_init(g, cfg, device)),
        "final_norm": rmsnorm_init(cfg.d_model, **kw),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = linear_init(gen, cfg.d_model, cfg.vocab,
                                        bias=False, **kw)
    return params


def lm_head(params: Params, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    """Final hidden states [..., D] -> logits [..., V] (the embedding
    table's transpose where the config ties them)."""
    if cfg.tie_embeddings:
        return x @ params["embed"]["table"].T.to(x.dtype)
    return linear(params["lm_head"], x)


def lm_forward(params: Params, cfg: LMConfig, tokens: torch.Tensor, *,
               impl: str = "xla") -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, V]. With cfg.remat each layer is
    recomputed in the backward pass (layers.remat)."""
    s = tokens.shape[1]
    x = embedding(params["embed"], tokens)
    angles = attn.rope_frequencies(cfg.resolved_head_dim, s, cfg.rope_theta,
                                   device=x.device)
    for i in range(cfg.n_layers):
        x = remat(cfg.remat, dense_block, layer_params(params["layers"], i),
                  x, cfg, angles, impl)
    return lm_head(params, cfg, rmsnorm(params["final_norm"], x))


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of labels [B, S] under logits
    [B, S, V], in float32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long()).squeeze(-1).mean()


def lm_loss(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    return token_nll(lm_forward(params, cfg, tokens), labels)


def lm_params_from_numpy(tree, dtype, device=None) -> Params:
    """The reference's LM parameters (nested dicts and lists of arrays,
    as `lm_init` / `moe_lm_init` in the JAX package make them) -> the
    same tree of tensors on `device` (the card unless the caller passes
    "cpu"): floating leaves in `dtype` (the config's), the MoE routers'
    weights in float32 (as the reference keeps them whatever the
    dtype)."""
    return params_from_numpy(tree, dtype, device, keep_float32=("router",))
