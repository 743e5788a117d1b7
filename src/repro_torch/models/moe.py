"""Mixture-of-Experts layer: top-k router and capacity-based static
dispatch (the GShard/MaxText formulation the reference uses):

  1. router logits [T, E] -> top-k gates (renormalised over the chosen);
  2. assignments sorted by expert (a stable sort), each one's position
     within its expert from run ranks, a fixed per-expert capacity C
     (assignments past it are dropped);
  3. tokens scattered into a dense [E, C, D] buffer;
  4. the experts' SwiGLU FFN as batched products over E;
  5. gathered back, weighted by the gates, summed over k.

A shared-expert branch (DeepSeek/Kimi) runs densely over all tokens.
Ties go as in the reference: top-k toward the lower expert index, the
sort keeps equal experts in token order, so the same assignments
overflow and are dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.models.layers import Params, linear_init, silu, trunc_normal


class MoEMetrics(NamedTuple):
    aux_loss: torch.Tensor        # load-balancing loss (Switch-style)
    dropped_frac: torch.Tensor    # fraction of (token, k) assignments dropped


def moe_init(gen, cfg: LMConfig, device=None) -> Params:
    e, dff = cfg.moe_experts, cfg.moe_d_ff
    kw = dict(std=0.02, device=device, dtype=cfg.dtype)
    p = {
        # the router stays float32 whatever the config's dtype
        "router": {"w": trunc_normal(gen, (cfg.d_model, e), std=0.02,
                                     device=device)},
        # stacked expert weights: [E, d_model, dff] / [E, dff, d_model]
        "w_gate": trunc_normal(gen, (e, cfg.d_model, dff), **kw),
        "w_up": trunc_normal(gen, (e, cfg.d_model, dff), **kw),
        "w_down": trunc_normal(gen, (e, dff, cfg.d_model), **kw),
    }
    if cfg.moe_shared_experts > 0:
        sdff = dff * cfg.moe_shared_experts
        lw = dict(bias=False, device=device, dtype=cfg.dtype)
        p["shared"] = {
            "gate": linear_init(gen, cfg.d_model, sdff, **lw),
            "up": linear_init(gen, cfg.d_model, sdff, **lw),
            "down": linear_init(gen, sdff, cfg.d_model, **lw),
        }
    return p


def router_topk(router_w: torch.Tensor, x: torch.Tensor, top_k: int):
    """x [T, D] -> (gates [T, k], ids [T, k], probs [T, E]). Equal
    probabilities rank by the lower expert index (jax.lax.top_k's
    order), by a stable sort."""
    probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
    neg, ids = torch.sort(-probs, dim=-1, stable=True)
    gates, ids = -neg[:, :top_k], ids[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, ids, probs


def _positions_in_runs(sorted_keys: torch.Tensor) -> torch.Tensor:
    """For a sorted int tensor, the rank of each element within its run
    of equal values."""
    n = sorted_keys.shape[0]
    idx = torch.arange(n, device=sorted_keys.device)
    is_start = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    return idx - seg_start


def capacity(tokens: int, cfg: LMConfig, capacity_factor: float) -> int:
    """Slots per expert: ceil(T * K * cf / E), at least 8, rounded up to
    a multiple of 8 and at most max(T, 8) (the reference's formula)."""
    c = int(max(8, -(-int(tokens * cfg.moe_top_k * capacity_factor)
                     // cfg.moe_experts)))
    return min(c + (-c) % 8, max(tokens, 8))


def moe_dispatch(ids: torch.Tensor, c: int):
    """ids [T, K] -> (order, sorted experts, positions within expert,
    keep): the sort-based dispatch plan of T * K assignments."""
    e_flat = ids.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    pos_in_e = _positions_in_runs(sorted_e)
    return order, sorted_e, pos_in_e, pos_in_e < c


def moe_ffn(p: Params, x: torch.Tensor, cfg: LMConfig, *,
            capacity_factor: float = 1.25):
    """x [B, S, D] -> (y [B, S, D], MoEMetrics)."""
    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    t = b * s
    xt = x.reshape(t, d)

    gates, ids, probs = router_topk(p["router"]["w"], xt, k)
    c = capacity(t, cfg, capacity_factor)
    order, sorted_e, pos_in_e, keep = moe_dispatch(ids, c)
    dropped_frac = 1.0 - keep.float().mean()
    g_flat = gates.reshape(t * k).to(x.dtype)

    tok = order // k                                  # token of each slot
    safe_e = torch.where(keep, sorted_e, 0)
    safe_pos = torch.where(keep, pos_in_e, 0)
    keep_x = keep[:, None].to(x.dtype)
    vals = xt[tok] * keep_x                           # [T*K, D]
    buf = torch.zeros(e, c, d, dtype=x.dtype, device=x.device)
    # dropped rows add zeros at slot (0, 0), as in the reference
    buf.index_put_((safe_e, safe_pos), vals, accumulate=True)

    # the experts' SwiGLU FFN over the leading E axis
    h = silu(torch.bmm(buf, p["w_gate"].to(x.dtype))) \
        * torch.bmm(buf, p["w_up"].to(x.dtype))
    y_buf = torch.bmm(h, p["w_down"].to(x.dtype))

    # gather back, gate, unsort, sum over k
    y_sorted = y_buf[safe_e, safe_pos] * keep_x
    y_sorted = y_sorted * g_flat[order][:, None]
    y_flat = torch.zeros(t * k, d, dtype=x.dtype, device=x.device)
    y_flat[order] = y_sorted
    y = y_flat.reshape(t, k, d).sum(1)

    if "shared" in p:
        sh = p["shared"]
        hg = silu(xt @ sh["gate"]["w"].to(x.dtype))
        hu = xt @ sh["up"]["w"].to(x.dtype)
        y = y + (hg * hu) @ sh["down"]["w"].to(x.dtype)

    # Switch-style load-balancing loss
    me = probs.mean(0)
    ce = F.one_hot(ids[:, 0], e).float().mean(0)
    aux = e * torch.sum(me * ce)
    return y.reshape(b, s, d), MoEMetrics(aux, dropped_frac)
