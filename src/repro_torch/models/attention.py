"""Multi-head attention as the ViT detector runs it: q/k/v projections,
float32 logits, softmax, product with V — written as plain products, the
reference's "xla" path. (The flash-attention kernel is not on this
path.) Shapes follow [batch, seq, heads, head_dim]."""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import Params, linear, linear_init


def mha_init(gen, d_model: int, n_heads: int, *, device=None) -> Params:
    return {name: linear_init(gen, d_model, d_model, device=device)
            for name in ("wq", "wk", "wv", "wo")}


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q/k/v [B, S, H, D] -> [B, S, H, D], non-causal, no mask."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def attention(p: Params, x: torch.Tensor, *, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    q = linear(p["wq"], x).reshape(b, s, n_heads, -1)
    k = linear(p["wk"], x).reshape(b, s, n_heads, -1)
    v = linear(p["wv"], x).reshape(b, s, n_heads, -1)
    return linear(p["wo"], sdpa(q, k, v).reshape(b, s, -1))
