"""Attention: multi-head and grouped-query (GQA) blocks, multi-head
latent attention (MLA, DeepSeek-V2/V3), RoPE, Swin's windowed
attention, and the scaled-dot-product core behind one `impl` switch:

  - "xla":   plain PyTorch products with float32 logits (the reference
             path; sequences of CHUNKED_THRESHOLD or more run in query
             chunks so the logits stay bounded);
  - "flash": the flash-attention kernel (kernels/flash_attention: CUDA
             on the card, its plain version on the CPU).

Shapes follow [batch, seq, heads, head_dim] ("BSHD"); parameters are the
reference's dictionaries (`wq/wk/wv/wo`, each `w` and optional `b`; MLA's
`wq_a/q_a_norm/wq_b/wkv_a/kv_a_norm/wkv_b/wo`).
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layout import activation_sharding
from repro_torch.models.layers import (
    Params,
    batch_rows,
    constrain_spec,
    linear,
    linear_init,
    per_shard,
    rmsnorm,
    rmsnorm_init,
)

CHUNKED_THRESHOLD = 2048   # query length from which "xla" runs in chunks
CHUNK = 1024               # query rows per chunk


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """[max_seq, head_dim // 2] angles."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    return torch.outer(t, inv).to(dtype)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; angles [S, D/2] (already positioned)."""
    d_half = x.shape[-1] // 2
    x1, x2 = x[..., :d_half], x[..., d_half:]
    cos = torch.cos(angles)[None, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# scaled-dot-product attention
# ---------------------------------------------------------------------------

def sdpa_xla(q, k, v, *, causal: bool = False, bias=None, q_offset: int = 0,
             scale: float | None = None) -> torch.Tensor:
    """q/k [B, Sq|Sk, Hq|Hkv, D], v [B, Sk, Hkv, Dv], Hq % Hkv == 0.
    Masked logits are -1e30 (a row never goes NaN); bias, if given, is
    added to the float32 logits [B, Hkv, G, Sq, Sk]."""
    b, sq, hq, d = q.shape
    sk, hkv, dv = v.shape[1], v.shape[2], v.shape[3]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk",
                          q.float().reshape(b, sq, hkv, g, d),
                          k.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        logits = torch.where(kpos[None, :] <= qpos[:, None], logits, -1e30)
    if bias is not None:
        logits = logits + bias.float()
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(b, sq, hq, dv).to(q.dtype)


def sdpa_chunked(q, k, v, *, causal: bool = False, q_offset: int = 0,
                 scale: float | None = None,
                 chunk: int = CHUNK) -> torch.Tensor:
    """Exact attention with [chunk, Sk] logits per step: `sdpa_xla` over
    query chunks (Sq must be a multiple of `chunk`; otherwise one
    `sdpa_xla` call)."""
    sq = q.shape[1]
    if sq % chunk:
        return sdpa_xla(q, k, v, causal=causal, q_offset=q_offset,
                        scale=scale)
    return torch.cat([
        sdpa_xla(q[:, i:i + chunk], k, v, causal=causal,
                 q_offset=q_offset + i, scale=scale)
        for i in range(0, sq, chunk)], dim=1)


def _heads_axis(mesh, *heads: int):
    """"model" when the mesh's model axis divides every head count."""
    return "model" if all(
        activation_sharding(mesh, (h,), ("model",)).spec[0]
        for h in heads) else None


def split_heads(t: torch.Tensor, n_heads: int,
                head_dim: int = -1) -> torch.Tensor:
    """[B, S, n_heads * Dh] -> [B, S, n_heads, Dh]. On a mesh t is first
    laid out batch over the DP axes and features over `model` only where
    it divides n_heads, so the split is even (DTensor refuses an uneven
    one)."""
    if isinstance(t, DTensor):
        t = constrain_spec(t, ("data", None,
                               _heads_axis(t.device_mesh, n_heads)))
    return t.reshape(t.shape[0], t.shape[1], n_heads, head_dim)


def merge_heads(o: torch.Tensor) -> torch.Tensor:
    """[B, S, H, Dh] -> [B, S, H * Dh]; on a mesh laid out as
    split_heads lays its input out (and the gradient alike, so its
    split in the backward pass is even)."""
    y = o.reshape(o.shape[0], o.shape[1], -1)
    if isinstance(y, DTensor):
        y = constrain_spec(y, ("data", None,
                               _heads_axis(y.device_mesh, o.shape[2])))
    return y


def sdpa(q, k, v, *, causal: bool = False, bias=None, q_offset: int = 0,
         impl: str = "xla", scale: float | None = None) -> torch.Tensor:
    """Attention over q/k [B, Sq|Sk, Hq|Hkv, D], v [B, Sk, Hkv, Dv]. On
    DTensors it runs per shard: batch over the DP axes and heads over
    `model` where they divide (`layers.per_shard`)."""
    if impl not in ("xla", "flash"):
        raise ValueError(f"impl must be 'xla' or 'flash', got {impl!r}")
    if isinstance(q, DTensor):
        heads = _heads_axis(q.device_mesh, q.shape[2], k.shape[2])
        spec = ("data", None, heads, None)
        b_spec = None
        if bias is not None:
            b_spec = ("data" if bias.shape[0] == q.shape[0] else None,
                      heads if bias.shape[1] == k.shape[2] else None,
                      None, None, None)
        return per_shard(
            lambda q_, k_, v_, b_: sdpa(q_, k_, v_, causal=causal,
                                        bias=b_, q_offset=q_offset,
                                        impl=impl, scale=scale),
            (q, k, v, bias), (spec, spec, spec, b_spec))
    if impl == "flash" and bias is None:
        return flash_ops.flash_attention(q, k, v, causal=causal,
                                         q_offset=q_offset, scale=scale)
    if bias is None and q.shape[1] >= CHUNKED_THRESHOLD:
        return sdpa_chunked(q, k, v, causal=causal, q_offset=q_offset,
                            scale=scale)
    return sdpa_xla(q, k, v, causal=causal, bias=bias, q_offset=q_offset,
                    scale=scale)


# ---------------------------------------------------------------------------
# GQA block (dense LMs; the ViT with n_kv_heads == n_heads)
# ---------------------------------------------------------------------------

def gqa_init(gen, d_model: int, n_heads: int, n_kv_heads: int,
             head_dim: int | None = None, *, bias: bool = False,
             device=None, dtype=torch.float32) -> Params:
    head_dim = head_dim or d_model // n_heads
    kw = dict(bias=bias, device=device, dtype=dtype)
    return {
        "wq": linear_init(gen, d_model, n_heads * head_dim, **kw),
        "wk": linear_init(gen, d_model, n_kv_heads * head_dim, **kw),
        "wv": linear_init(gen, d_model, n_kv_heads * head_dim, **kw),
        "wo": linear_init(gen, n_heads * head_dim, d_model, **kw),
    }


def gqa_qkv(p: Params, x: torch.Tensor, n_heads: int, n_kv_heads: int):
    x = batch_rows(x)
    q = split_heads(linear(p["wq"], x), n_heads)
    k = split_heads(linear(p["wk"], x), n_kv_heads)
    v = split_heads(linear(p["wv"], x), n_kv_heads)
    return q, k, v


def gqa_qkv_rope(p: Params, x: torch.Tensor, n_heads: int, n_kv_heads: int,
                 angles: torch.Tensor | None = None):
    """q, k, v [B, S, H, Dh] with RoPE on q and k (angles for positions
    0..S-1)."""
    s = x.shape[1]
    q, k, v = gqa_qkv(p, x, n_heads, n_kv_heads)
    if angles is not None:
        q = apply_rope(q, angles[:s])
        k = apply_rope(k, angles[:s])
    return q, k, v


def gqa_attention(p: Params, x: torch.Tensor, *, n_heads: int,
                  n_kv_heads: int, angles: torch.Tensor | None = None,
                  causal: bool = True, impl: str = "xla") -> torch.Tensor:
    b, s, _ = x.shape
    q, k, v = gqa_qkv_rope(p, x, n_heads, n_kv_heads, angles)
    o = sdpa(q, k, v, causal=causal, impl=impl)
    return linear(p["wo"], merge_heads(o))


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2/V3)
# ---------------------------------------------------------------------------
# Queries, keys and values are projected through low-rank latents; the
# KV cache (models/kvcache.py) stores only the compressed latent and a
# small rope'd key part.

def mla_init(gen, d_model: int, n_heads: int, *, q_lora_rank: int,
             kv_lora_rank: int, qk_nope_dim: int, qk_rope_dim: int,
             v_head_dim: int, device=None, dtype=torch.float32) -> Params:
    qk_head_dim = qk_nope_dim + qk_rope_dim
    kw = dict(bias=False, device=device, dtype=dtype)
    return {
        "wq_a": linear_init(gen, d_model, q_lora_rank, **kw),
        "q_a_norm": rmsnorm_init(q_lora_rank, device=device, dtype=dtype),
        "wq_b": linear_init(gen, q_lora_rank, n_heads * qk_head_dim, **kw),
        "wkv_a": linear_init(gen, d_model, kv_lora_rank + qk_rope_dim,
                             **kw),
        "kv_a_norm": rmsnorm_init(kv_lora_rank, device=device,
                                  dtype=dtype),
        "wkv_b": linear_init(gen, kv_lora_rank,
                             n_heads * (qk_nope_dim + v_head_dim), **kw),
        "wo": linear_init(gen, n_heads * v_head_dim, d_model, **kw),
    }


def mla_project(p: Params, x: torch.Tensor, *, n_heads: int,
                qk_nope_dim: int, qk_rope_dim: int, v_head_dim: int,
                kv_lora_rank: int, angles: torch.Tensor | None = None):
    """x [B, S, D] -> (q, k [B, S, H, nope + rope], v [B, S, H, v_head],
    kv_lat [B, S, lora], k_rope [B, S, 1, rope]): the latents and the
    per-head keys and values expanded from them."""
    x = batch_rows(x)
    b, s, _ = x.shape
    qk_head_dim = qk_nope_dim + qk_rope_dim

    q_lat = rmsnorm(p["q_a_norm"], linear(p["wq_a"], x))
    q = split_heads(linear(p["wq_b"], q_lat), n_heads, qk_head_dim)
    q_nope, q_rope = q[..., :qk_nope_dim], q[..., qk_nope_dim:]

    kv_a = linear(p["wkv_a"], x)
    kv_lat = rmsnorm(p["kv_a_norm"], kv_a[..., :kv_lora_rank])
    k_rope = kv_a[..., kv_lora_rank:].reshape(b, s, 1, qk_rope_dim)

    kv = split_heads(linear(p["wkv_b"], kv_lat), n_heads,
                     qk_nope_dim + v_head_dim)
    k_nope, v = kv[..., :qk_nope_dim], kv[..., qk_nope_dim:]

    if angles is not None:
        q_rope = apply_rope(q_rope, angles[:s, :qk_rope_dim // 2])
        k_rope = apply_rope(k_rope, angles[:s, :qk_rope_dim // 2])

    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat(
        [k_nope, k_rope.expand(b, s, n_heads, qk_rope_dim)], dim=-1)
    return q_full, k_full, v, kv_lat, k_rope


def mla_attention(p: Params, x: torch.Tensor, *, n_heads: int,
                  qk_nope_dim: int, qk_rope_dim: int, v_head_dim: int,
                  kv_lora_rank: int, angles: torch.Tensor | None = None,
                  causal: bool = True, impl: str = "xla") -> torch.Tensor:
    """The training / prefill form of MLA, latents expanded to per-head
    keys and values (the cache form is in kvcache.py). With
    impl="flash", v is zero-padded to the query/key head width for the
    kernel (which takes one head width) and the output cut back; as in
    the reference, every other case runs "xla"."""
    b, s, _ = x.shape
    qk_head_dim = qk_nope_dim + qk_rope_dim
    q, k, v, _, _ = mla_project(
        p, x, n_heads=n_heads, qk_nope_dim=qk_nope_dim,
        qk_rope_dim=qk_rope_dim, v_head_dim=v_head_dim,
        kv_lora_rank=kv_lora_rank, angles=angles)
    scale = 1.0 / math.sqrt(qk_head_dim)
    if impl == "flash" and v_head_dim != qk_head_dim:
        pad = qk_head_dim - v_head_dim
        v_p = torch.nn.functional.pad(v, (0, max(0, pad)))
        o = sdpa(q, k, v_p, causal=causal, impl=impl, scale=scale)
        o = o[..., :v_head_dim]
    else:
        o = sdpa(q, k, v, causal=causal, impl="xla", scale=scale)
    return linear(p["wo"], merge_heads(o))


# ---------------------------------------------------------------------------
# windowed attention (Swin)
# ---------------------------------------------------------------------------

def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B * nW, window * window, C], windows row-major
    within each image."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_unpartition(wins: torch.Tensor, window: int, h: int,
                       w: int) -> torch.Tensor:
    """[B * nW, window * window, C] -> [B, H, W, C]."""
    b = wins.shape[0] // ((h // window) * (w // window))
    x = wins.reshape(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def shifted_window_mask(h: int, w: int, window: int, shift: int,
                        device=None) -> torch.Tensor:
    """Additive bias [nW, window^2, window^2] for shifted windows: 0
    between tokens of one region of the rolled map, -1e9 across
    regions."""
    img = torch.zeros(1, h, w, 1, device=device)
    cnt = 0
    h_slices = ((0, h - window), (h - window, h - shift), (h - shift, h))
    w_slices = ((0, w - window), (w - window, w - shift), (w - shift, w))
    for hs, he in h_slices:
        for ws, we in w_slices:
            img[:, hs:he, ws:we, :] = cnt
            cnt += 1
    wins = window_partition(img, window).squeeze(-1)      # [nW, window^2]
    diff = wins[:, :, None] - wins[:, None, :]
    return torch.where(diff == 0, 0.0, -1e9)


def window_attention(p: Params, x: torch.Tensor, *, n_heads: int,
                     rel_bias: torch.Tensor | None = None,
                     mask: torch.Tensor | None = None,
                     impl: str = "xla") -> torch.Tensor:
    """x [nWB, T, C] windows; rel_bias [n_heads, T, T]; mask [nW, T, T].
    Runs the plain biased attention whatever `impl` is, as the
    reference's does (the flash kernel takes no bias)."""
    nwb, t, c = x.shape
    x = batch_rows(x)
    q = split_heads(linear(p["wq"], x), n_heads)
    k = split_heads(linear(p["wk"], x), n_heads)
    v = split_heads(linear(p["wv"], x), n_heads)
    bias = None
    if rel_bias is not None:
        bias = rel_bias[None, :, None]          # [1, H, 1, T, T]
    if mask is not None:
        m = mask.repeat(nwb // mask.shape[0], 1, 1)[:, None, None]
        bias = m if bias is None else bias + m
    o = sdpa(q, k, v, causal=False, bias=bias)
    return linear(p["wo"], merge_heads(o))
