"""KV caches and the prefill / decode serving steps of the dense and
MoE LMs.

Two cache layouts, bf16 whatever the model's dtype (as the reference's):
  - GQA: k / v [L, B, max_seq, Hkv, Dh]           (StableLM, Kimi)
  - MLA: kv_latent [L, B, max_seq, lora] + k_rope [L, B, max_seq, rope]
    (DeepSeek): the compressed cache; decode absorbs wkv_b into the
    query and the output, so a step costs O(S * H * (lora + rope)).

`length` is a host int (the tokens the cache holds). A decode step
writes the new token's keys into the cache's tensors in place and
returns a cache that shares them with its argument (the reference
returns new arrays; in place keeps a step from copying the cache).
Prefill and decode run the plain ("xla") attention, as the reference's
do.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import LMConfig
from repro_torch.devices import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    Params,
    embedding,
    layer_params,
    linear,
    mlp,
    per_shard,
    rmsnorm,
    zeros_laid_out,
)
from repro_torch.models import moe
from repro_torch.models.layout import TensorSpec
from repro_torch.models.moe_lm import mla_dims, n_moe_layers
from repro_torch.models.transformer import lm_head

CACHE_DTYPE = torch.bfloat16

# a prefill's cache on a mesh (distributed/sharding.kvcache_shardings):
# batch over the DP axes, GQA's kv heads over `model` where they divide
_GQA_SPEC = (None, "data", None, "model", None)
_MLA_SPEC = (None, "data", None, None)


class GQACache(NamedTuple):
    k: torch.Tensor       # [L, B, S_max, Hkv, Dh]
    v: torch.Tensor       # [L, B, S_max, Hkv, Dh]
    length: int           # tokens currently valid


class MLACache(NamedTuple):
    kv_latent: torch.Tensor  # [L, B, S_max, lora]
    k_rope: torch.Tensor     # [L, B, S_max, rope]
    length: int


def cache_specs(cfg: LMConfig, batch: int, max_seq: int,
                dtype=CACHE_DTYPE):
    """The cache's shapes and dtypes, nothing allocated (the dry run's):
    a GQACache or MLACache of `TensorSpec`s, `length` a [] int32 spec as
    in the reference (a real cache holds a host int there). The one
    place the cache's shape is written."""
    length = TensorSpec((), torch.int32)
    lead = (cfg.n_layers, batch, max_seq)
    if cfg.mla:
        return MLACache(TensorSpec(lead + (cfg.kv_lora_rank,), dtype),
                        TensorSpec(lead + (cfg.qk_rope_dim,), dtype), length)
    s = TensorSpec(lead + (cfg.n_kv_heads, cfg.resolved_head_dim), dtype)
    return GQACache(s, s, length)


def _empty_cache(cfg: LMConfig, batch: int, max_seq: int, zeros):
    """cache_specs' cache with zeros(spec) in each tensor and length 0."""
    specs = cache_specs(cfg, batch, max_seq)
    return type(specs)(*(zeros(s) for s in specs[:-1]), 0)


def init_gqa_cache(cfg: LMConfig, batch: int, max_seq: int,
                   dtype=CACHE_DTYPE, device=None) -> GQACache:
    """An empty cache on `device` (the card unless the caller passes
    "cpu")."""
    device = resolve_device(device)
    return _empty_cache(cfg, batch, max_seq, lambda s: torch.zeros(
        s.shape, dtype=dtype, device=device))


def init_mla_cache(cfg: LMConfig, batch: int, max_seq: int,
                   dtype=CACHE_DTYPE, device=None) -> MLACache:
    """An empty cache on `device` (the card unless the caller passes
    "cpu")."""
    device = resolve_device(device)
    return _empty_cache(cfg, batch, max_seq, lambda s: torch.zeros(
        s.shape, dtype=dtype, device=device))


def _prefill_cache(cfg: LMConfig, x: torch.Tensor, max_seq: int):
    """A prefill's empty cache, for x [B, S, D]: on x's device, and on
    a mesh laid out batch over the DP axes, GQA's kv heads over `model`
    where they divide (distributed/sharding.kvcache_shardings)."""
    spec = _MLA_SPEC if cfg.mla else _GQA_SPEC
    return _empty_cache(cfg, x.shape[0], max_seq, lambda s: zeros_laid_out(
        x, s.shape, spec, s.dtype))


def _layers(params: Params, cfg: LMConfig) -> list:
    """Every layer's parameters in order: a dense LM's stacked layers, or
    an MoE LM's dense layers then its stacked MoE layers."""
    if "layers" in params:
        return [layer_params(params["layers"], i)
                for i in range(cfg.n_layers)]
    return list(params["dense_layers"]) + [
        layer_params(params["moe_layers"], i)
        for i in range(n_moe_layers(cfg))]


def _moe_or_mlp(lp: Params, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    h = rmsnorm(lp["mlp_norm"], x)
    if "moe" in lp:
        return x + moe.moe_ffn(lp["moe"], h, cfg)[0]
    return x + mlp(lp["mlp"], h)


def _check_room(length: int, max_seq: int) -> None:
    if length >= max_seq:
        raise ValueError(f"decode: the cache holds {max_seq} positions and "
                         f"is full")


def _position_angles(dim: int, max_seq: int, length: int, cfg: LMConfig,
                     device) -> torch.Tensor:
    """[1, dim // 2] rope angles of position `length`."""
    return attn.rope_frequencies(dim, max_seq, cfg.rope_theta,
                                 device=device)[length:length + 1]


# ---------------------------------------------------------------------------
# GQA: masked decode attention over a cache slice, prefill, decode
# ---------------------------------------------------------------------------

def _write(cache: torch.Tensor, pos: int, value: torch.Tensor) -> None:
    """cache[:, pos] = value (cache [B, S_max, ...], value [B, ...]) in
    the cache's dtype. A partial value is summed before it is cast (a
    cast of its terms would round each). A cache whose sequence axis is
    sharded over `model` is written in its shards: every rank lays the
    value out batch as the cache is, the rank holding position pos
    writes it."""
    if isinstance(value, DTensor) and any(
            p.is_partial() for p in value.placements):
        value = value.redistribute(value.device_mesh, [
            Replicate() if p.is_partial() else p for p in value.placements])
    if not (isinstance(cache, DTensor)
            and any(p.is_shard(1) for p in cache.placements)):
        cache[:, pos] = value.to(cache.dtype)
        return
    mesh = cache.device_mesh
    whole = [Shard(0) if p.is_shard(0) else Replicate()
             for p in cache.placements]
    if isinstance(value, DTensor):
        value = value.redistribute(mesh, whole).to_local()
    local = cache.to_local()
    s = local.shape[1]
    at = pos - mesh.get_local_rank(mesh.mesh_dim_names.index("model")) * s
    if 0 <= at < s:
        local[:, at] = value.to(local.dtype)


def _decode_attend(q, k_cache, v_cache, length: int, scale: float):
    """q [B, 1, Hq, D]; k/v [B, S, Hkv, D]; attends to positions <=
    length (the new token's). On DTensors it runs per shard: batch
    over the DP axes and heads over `model` where they divide, or, for a
    sequence-sharded cache, `_decode_attend_split`."""
    if isinstance(k_cache, DTensor) and any(
            p.is_shard(1) for p in k_cache.placements):
        return _decode_attend_split(q, k_cache, v_cache, length, scale)
    if isinstance(k_cache, DTensor):
        heads = attn._heads_axis(k_cache.device_mesh, q.shape[2],
                                 k_cache.shape[2])
        spec = ("data", None, heads, None)
        return per_shard(
            lambda q_, k_, v_: _decode_attend(q_, k_, v_, length, scale),
            (q, k_cache, v_cache), (spec, spec, spec))
    b, s, hkv, d = k_cache.shape
    hq = q.shape[2]
    qg = q.float().reshape(b, 1, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.float()) * scale
    valid = torch.arange(s, device=q.device) <= length
    logits = torch.where(valid, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v_cache.float())
    return o.reshape(b, 1, hq, d).to(q.dtype)


def _decode_attend_split(q, k_cache, v_cache, length: int, scale: float):
    """_decode_attend over a cache whose sequence axis is sharded over
    `model` (sequence parallelism): each rank attends its slice of the
    positions (masked by their global index) and the softmax is combined
    across the slices, a max and two sums over `model` (the split-S
    softmax GSPMD makes of the reference's masked softmax)."""
    mesh = k_cache.device_mesh
    mdim = mesh.mesh_dim_names.index("model")
    whole = [Shard(0) if p.is_shard(0) else Replicate()
             for p in k_cache.placements]
    ql = q.redistribute(mesh, whole).to_local() \
        if isinstance(q, DTensor) else q
    kl, vl = k_cache.to_local(), v_cache.to_local()
    b, s, hkv, d = kl.shape
    hq = ql.shape[2]

    def combine(t, op):
        pl = [Partial(op) if i == mdim else p for i, p in enumerate(whole)]
        return DTensor.from_local(t, mesh, pl, run_check=False
                                  ).redistribute(mesh, whole).to_local()

    qg = ql.float().reshape(b, 1, hkv, hq // hkv, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kl.float()) * scale
    pos = torch.arange(s, device=kl.device) + mesh.get_local_rank(mdim) * s
    logits = torch.where(pos <= length, logits, -1e30)
    m = combine(logits.amax(-1, keepdim=True), "max")
    w = torch.exp(logits - m)
    denom = combine(w.sum(-1, keepdim=True), "sum")     # [B, Hkv, G, 1, 1]
    o = combine(torch.einsum("bhgqk,bkhd->bqhgd", w, vl.float()), "sum")
    o = o / denom.permute(0, 3, 1, 2, 4)
    return DTensor.from_local(o.reshape(b, 1, hq, d).to(ql.dtype), mesh,
                              whole, run_check=False)


def _gqa_block_decode(lp: Params, x, k_cache, v_cache, length: int,
                      cfg: LMConfig, angles_pos):
    """One block's attention at decode, then its MLP or MoE; writes the
    token's k / v into k_cache / v_cache [B, S_max, Hkv, Dh] at
    `length`."""
    b = x.shape[0]
    dh = cfg.resolved_head_dim
    h = rmsnorm(lp["attn_norm"], x)
    q = attn.split_heads(linear(lp["attn"]["wq"], h), cfg.n_heads, dh)
    k = attn.split_heads(linear(lp["attn"]["wk"], h), cfg.n_kv_heads, dh)
    v = attn.split_heads(linear(lp["attn"]["wv"], h), cfg.n_kv_heads, dh)
    q = attn.apply_rope(q, angles_pos)
    k = attn.apply_rope(k, angles_pos)
    _write(k_cache, length, k[:, 0])
    _write(v_cache, length, v[:, 0])
    o = _decode_attend(q, k_cache, v_cache, length, 1.0 / math.sqrt(dh))
    x = x + linear(lp["attn"]["wo"], o.reshape(b, 1, -1))
    return _moe_or_mlp(lp, x, cfg)


def _gqa_decode(params: Params, cfg: LMConfig, token: torch.Tensor,
                cache: GQACache):
    _check_room(cache.length, cache.k.shape[2])
    x = embedding(params["embed"], token)
    angles_pos = _position_angles(cfg.resolved_head_dim, cache.k.shape[2],
                                  cache.length, cfg, x.device)
    for i, lp in enumerate(_layers(params, cfg)):
        x = _gqa_block_decode(lp, x, cache.k[i], cache.v[i], cache.length,
                              cfg, angles_pos)
    logits = lm_head(params, cfg, rmsnorm(params["final_norm"], x))
    return logits, GQACache(cache.k, cache.v, cache.length + 1)


def gqa_decode_step(params: Params, cfg: LMConfig, token: torch.Tensor,
                    cache: GQACache):
    """Dense LM: token [B, 1] -> (logits [B, 1, V], cache')."""
    return _gqa_decode(params, cfg, token, cache)


def moe_gqa_decode_step(params: Params, cfg: LMConfig, token: torch.Tensor,
                        cache: GQACache):
    """MoE-GQA LM (Kimi): token [B, 1] -> (logits [B, 1, V], cache')."""
    return _gqa_decode(params, cfg, token, cache)


def _gqa_prefill(params: Params, cfg: LMConfig, tokens: torch.Tensor,
                 max_seq: int | None, last_only: bool):
    b, s = tokens.shape
    max_seq = max_seq or s
    x = embedding(params["embed"], tokens)
    angles = attn.rope_frequencies(cfg.resolved_head_dim, s, cfg.rope_theta,
                                   device=x.device)
    cache = _prefill_cache(cfg, x, max_seq)
    for i, lp in enumerate(_layers(params, cfg)):
        h = rmsnorm(lp["attn_norm"], x)
        q, k, v = attn.gqa_qkv_rope(lp["attn"], h, cfg.n_heads,
                                    cfg.n_kv_heads, angles)
        o = attn.sdpa(q, k, v, causal=True, impl="xla")
        x = x + linear(lp["attn"]["wo"], o.reshape(b, s, -1))
        x = _moe_or_mlp(lp, x, cfg)
        cache.k[i, :, :s] = k
        cache.v[i, :, :s] = v
    x = rmsnorm(params["final_norm"], x)
    if last_only:
        x = x[:, -1:]
    return lm_head(params, cfg, x), GQACache(cache.k, cache.v, s)


def gqa_prefill(params: Params, cfg: LMConfig, tokens: torch.Tensor,
                max_seq: int | None = None, *, last_only: bool = False):
    """Dense LM: tokens [B, S] -> (logits [B, S, V], GQACache filled to
    S of max_seq). last_only=True computes the last position's logits
    only (what serving samples from)."""
    return _gqa_prefill(params, cfg, tokens, max_seq, last_only)


def moe_gqa_prefill(params: Params, cfg: LMConfig, tokens: torch.Tensor,
                    max_seq: int | None = None, *, last_only: bool = False):
    """MoE-GQA LM (Kimi): tokens [B, S] -> (logits, GQACache)."""
    return _gqa_prefill(params, cfg, tokens, max_seq, last_only)


# ---------------------------------------------------------------------------
# MLA (DeepSeek): prefill, and decode with weight absorption
# ---------------------------------------------------------------------------

def _mla_block_decode(lp: Params, x, kv_lat_cache, k_rope_cache,
                      length: int, cfg: LMConfig, angles_pos):
    """One block's MLA attention at decode over the compressed cache
    (kv_lat_cache [B, S_max, lora], k_rope_cache [B, S_max, rope],
    written at `length`): q_nope is absorbed into the latent space
    through wkv_b's key part, the output through its value part."""
    b = x.shape[0]
    hn = cfg.n_heads
    nope, rope, vd, lora = (cfg.qk_nope_dim, cfg.qk_rope_dim,
                            cfg.v_head_dim, cfg.kv_lora_rank)
    ap = lp["attn"]
    h = rmsnorm(lp["attn_norm"], x)

    q_lat = rmsnorm(ap["q_a_norm"], linear(ap["wq_a"], h))
    q = attn.split_heads(linear(ap["wq_b"], q_lat), hn, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = attn.apply_rope(q_rope, angles_pos[:, :rope // 2])

    kv_a = linear(ap["wkv_a"], h)                        # [B, 1, lora+rope]
    kv_lat = rmsnorm(ap["kv_a_norm"], kv_a[..., :lora])  # [B, 1, lora]
    k_rope_new = attn.apply_rope(
        kv_a[..., lora:].reshape(b, 1, 1, rope), angles_pos[:, :rope // 2]
    ).reshape(b, rope)
    _write(kv_lat_cache, length, kv_lat[:, 0])
    _write(k_rope_cache, length, k_rope_new)

    # weight absorption: wkv_b [lora, H * (nope + vd)] split into K and V
    wkvb = ap["wkv_b"]["w"].reshape(lora, hn, nope + vd).float()
    w_k, w_v = wkvb[..., :nope], wkvb[..., nope:]
    q_abs = torch.einsum("bqhn,lhn->bqhl", q_nope.float(), w_k)

    s = kv_lat_cache.shape[1]
    lat = kv_lat_cache.float()
    logits = (torch.einsum("bqhl,bsl->bhqs", q_abs, lat)
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                             k_rope_cache.float())) \
        * (1.0 / math.sqrt(nope + rope))
    valid = torch.arange(s, device=x.device) <= length
    w = torch.softmax(torch.where(valid, logits, -1e30), dim=-1)
    o_lat = torch.einsum("bhqs,bsl->bqhl", w, lat)        # [B, 1, H, lora]
    o = torch.einsum("bqhl,lhv->bqhv", o_lat, w_v)
    return x + linear(ap["wo"], o.reshape(b, 1, hn * vd).to(x.dtype))


def mla_decode_step(params: Params, cfg: LMConfig, token: torch.Tensor,
                    cache: MLACache):
    """MoE-MLA LM (DeepSeek): token [B, 1] -> (logits [B, 1, V],
    cache')."""
    s_max = cache.kv_latent.shape[2]
    _check_room(cache.length, s_max)
    x = embedding(params["embed"], token)
    angles_pos = _position_angles(cfg.qk_rope_dim, s_max, cache.length, cfg,
                                  x.device)
    for i, lp in enumerate(_layers(params, cfg)):
        x = _mla_block_decode(lp, x, cache.kv_latent[i], cache.k_rope[i],
                              cache.length, cfg, angles_pos)
        x = _moe_or_mlp(lp, x, cfg)
    logits = lm_head(params, cfg, rmsnorm(params["final_norm"], x))
    return logits, MLACache(cache.kv_latent, cache.k_rope, cache.length + 1)


def mla_prefill(params: Params, cfg: LMConfig, tokens: torch.Tensor,
                max_seq: int | None = None, *, last_only: bool = False):
    """MoE-MLA LM (DeepSeek): tokens [B, S] -> (logits, MLACache). The
    cache holds only the compressed latent and the rope'd key: (lora +
    rope) values a token and layer against GQA's 2 * Hkv * Dh."""
    b, s = tokens.shape
    max_seq = max_seq or s
    hn, vd = cfg.n_heads, cfg.v_head_dim
    x = embedding(params["embed"], tokens)
    angles = attn.rope_frequencies(cfg.qk_rope_dim, s, cfg.rope_theta,
                                   device=x.device)
    cache = _prefill_cache(cfg, x, max_seq)
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    for i, lp in enumerate(_layers(params, cfg)):
        h = rmsnorm(lp["attn_norm"], x)
        q, k, v, kv_lat, k_rope = attn.mla_project(
            lp["attn"], h, angles=angles, **mla_dims(cfg))
        o = attn.sdpa(q, k, v, causal=True, impl="xla", scale=scale)
        x = x + linear(lp["attn"]["wo"], o.reshape(b, s, hn * vd))
        x = _moe_or_mlp(lp, x, cfg)
        cache.kv_latent[i, :, :s] = kv_lat
        cache.k_rope[i, :, :s] = k_rope[:, :, 0]
    x = rmsnorm(params["final_norm"], x)
    if last_only:
        x = x[:, -1:]
    return lm_head(params, cfg, x), MLACache(cache.kv_latent, cache.k_rope,
                                             s)
