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

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import LMConfig
from repro_torch.models.layout import activation_sharding
from repro_torch.models.layers import (
    Params,
    constrain_spec,
    linear,
    linear_init,
    silu,
    trunc_normal,
)


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


def moe_dispatch(ids: torch.Tensor, c: int,
                 ahead: torch.Tensor | None = None):
    """ids [T, K] -> (order, sorted experts, positions within expert,
    keep): the sort-based dispatch plan of T * K assignments. `ahead`
    [E]: assignments to each expert that precede these in the global
    order (the tokens of earlier DP shards), added to the positions."""
    e_flat = ids.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    pos_in_e = _positions_in_runs(sorted_e)
    if ahead is not None:
        pos_in_e = pos_in_e + ahead[sorted_e]
    return order, sorted_e, pos_in_e, pos_in_e < c


class _Plan(NamedTuple):
    """One dispatch: where each (token, k) assignment goes."""
    order: torch.Tensor
    safe_e: torch.Tensor
    safe_pos: torch.Tensor
    keep_x: torch.Tensor
    g_flat: torch.Tensor
    ids: torch.Tensor
    probs: torch.Tensor
    dropped_frac: torch.Tensor


def _dispatch(xt: torch.Tensor, routed: tuple, cfg: LMConfig, c: int,
              ahead=None, experts: tuple | None = None):
    """Scatter xt [T, D], routed = router_topk's (gates, ids, probs),
    into the [E, C, D] buffer (C = c slots an expert). On a mesh shard,
    `ahead(ids)` gives each expert's assignments in the DP shards before
    this one (moe_dispatch's `ahead`), and `experts` = (e0, n) the
    experts whose slots this rank fills: the buffer is [n, C, D], other
    assignments are left out as dropped ones are."""
    t, d = xt.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    gates, ids, probs = routed
    order, sorted_e, pos_in_e, keep = moe_dispatch(
        ids, c, None if ahead is None else ahead(ids))
    dropped_frac = 1.0 - keep.float().mean()
    e0, n = experts or (0, e)
    if experts is not None:
        keep = keep & (sorted_e >= e0) & (sorted_e < e0 + n)
    g_flat = gates.reshape(t * k).to(xt.dtype)

    tok = order // k                                  # token of each slot
    safe_e = torch.where(keep, sorted_e - e0, 0)
    safe_pos = torch.where(keep, pos_in_e, 0)
    keep_x = keep[:, None].to(xt.dtype)
    vals = xt[tok] * keep_x                           # [T*K, D]
    buf = torch.zeros(n, c, d, dtype=xt.dtype, device=xt.device)
    # dropped rows add zeros at slot (0, 0), as in the reference
    buf.index_put_((safe_e, safe_pos), vals, accumulate=True)
    return buf, _Plan(order, safe_e, safe_pos, keep_x, g_flat, ids, probs,
                      dropped_frac)


def _experts(p: Params, buf: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU FFN over the leading E axis."""
    h = silu(torch.bmm(buf, p["w_gate"].to(buf.dtype))) \
        * torch.bmm(buf, p["w_up"].to(buf.dtype))
    return torch.bmm(h, p["w_down"].to(buf.dtype))


def _gather(y_buf: torch.Tensor, plan: _Plan) -> torch.Tensor:
    """Each assignment's expert output, back in (token, k) order (zero
    where dropped) -> [T*K, D]."""
    tk, d = plan.order.shape[0], y_buf.shape[-1]
    y_sorted = y_buf[plan.safe_e, plan.safe_pos] * plan.keep_x
    y_flat = torch.zeros(tk, d, dtype=y_buf.dtype, device=y_buf.device)
    y_flat[plan.order] = y_sorted
    return y_flat


def _weigh(y_flat: torch.Tensor, g_flat: torch.Tensor, k: int
           ) -> torch.Tensor:
    """Gate each assignment's output and sum over k -> [T, D]."""
    tk, d = y_flat.shape
    return (y_flat * g_flat[:, None]).reshape(tk // k, k, d).sum(1)


def _shared(p: Params, xt: torch.Tensor) -> torch.Tensor:
    """The shared experts' SwiGLU (bias-free linears)."""
    sh = p["shared"]
    hg = silu(linear(sh["gate"], xt))
    hu = linear(sh["up"], xt)
    return linear(sh["down"], hg * hu)


def _aux(plan: _Plan, e: int, mean=None) -> torch.Tensor:
    """Switch-style load-balancing loss: e * sum(me * ce) of the mean
    router probability and the mean top-1 share of each expert over all
    tokens (`mean(v)` makes a shard's mean the mean over every DP
    shard)."""
    mean = mean or (lambda v: v)
    me = mean(plan.probs.mean(0))
    ce = mean(F.one_hot(plan.ids[:, 0], e).float().mean(0))
    return e * torch.sum(me * ce)


def moe_ffn(p: Params, x: torch.Tensor, cfg: LMConfig, *,
            capacity_factor: float = 1.25):
    """x [B, S, D] -> (y [B, S, D], MoEMetrics). On DTensors, see
    `_moe_ffn_mesh`."""
    if isinstance(x, DTensor):
        return _moe_ffn_mesh(p, x, cfg, capacity_factor)
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    routed = router_topk(p["router"]["w"], xt, cfg.moe_top_k)
    buf, plan = _dispatch(xt, routed, cfg,
                          capacity(b * s, cfg, capacity_factor))
    y = _weigh(_gather(_experts(p, buf), plan), plan.g_flat, cfg.moe_top_k)
    if "shared" in p:
        y = y + _shared(p, xt)
    return y.reshape(b, s, d), MoEMetrics(_aux(plan, cfg.moe_experts),
                                          plan.dropped_frac)


def _moe_ffn_mesh(p: Params, x: torch.Tensor, cfg: LMConfig,
                  capacity_factor: float):
    """The layer on a mesh (DTensors), with the plain layer's result.
    x is laid out batch over the DP axes. Each rank routes its shard's
    tokens; the expert counts of all shards (an all-gather of [E]
    ints) place each assignment where the global sort puts it, so the
    capacity (from the global token count), the dropped assignments and
    the slots are the plain layer's. Each rank scatters its tokens into
    the [E / M, C, D] slots of its `model` rank's experts (expert
    parallelism where M divides E), a partial sum over the DP ranks that
    is reduce-scattered onto the capacity axis; the experts run on their
    shard, the results are all-gathered back over the DP axes, each
    rank gathers its tokens' results from its experts, and the gated
    sum over k, partial over `model`, is completed there. The
    load-balancing loss and the dropped fraction are the global ones.

    Gradients: a local tensor that feeds only this rank's share of a
    sum (the router weights over the DP ranks; x, the gates and the
    gathered results over `model` or the DP ranks) declares its
    gradient partial there (`to_local`'s / `from_local`'s layouts), so
    DTensor sums it."""
    mesh = x.device_mesh
    e, k = cfg.moe_experts, cfg.moe_top_k
    x = constrain_spec(x, ("data", None, None))
    b, s, d = x.shape
    dp = [i for i, q in enumerate(x.placements) if q.is_shard(0)]
    n_dp = math.prod(mesh.size(i) for i in dp)
    coord = mesh.get_coordinate()
    ep = activation_sharding(mesh, (e,), ("model",)).spec[0] is not None
    m = mesh.mesh_dim_names.index("model") if ep else None

    def pl(on_dp, on_model):
        """Placements: `on_dp` over the DP dims of x's batch, `on_model`
        over `model` where the experts are split over it."""
        return [on_dp if i in dp else on_model if i == m else Replicate()
                for i in range(mesh.ndim)]

    whole = [Replicate()] * mesh.ndim
    router_w = p["router"]["w"].redistribute(mesh, whole).to_local(
        grad_placements=pl(Partial(), Replicate()))
    xt = x.to_local().reshape(-1, d)
    # the scatter's view of x: on `model`, each rank's experts' share
    xt_e = x.to_local(grad_placements=pl(Shard(0), Partial())
                      ).reshape(-1, d)

    def ahead(ids):
        """Each expert's assignments in the DP shards before this one."""
        flat = ids.reshape(-1)
        mine = torch.zeros(e, dtype=torch.int64, device=ids.device
                           ).scatter_add_(0, flat, torch.ones_like(flat))
        every = DTensor.from_local(mine[None], mesh, pl(Shard(0),
                                                        Replicate()),
                                   run_check=False).full_tensor()
        rank = 0
        for i in dp:
            rank = rank * mesh.size(i) + coord[i]
        return every[:rank].sum(0)

    e_n = e // mesh.size(m) if ep else e
    c = capacity(xt.shape[0] * n_dp, cfg, capacity_factor)
    buf, plan = _dispatch(xt_e, router_topk(router_w, xt, k), cfg, c,
                          ahead, (coord[m] * e_n, e_n) if ep else None)

    # [E, C, D]: this rank's experts, a partial sum over the DP ranks,
    # then the capacity axis over them; the experts' output and its
    # gradient laid out alike (a partial gradient left as it is would
    # run the experts' backward at the whole capacity)
    spec = ("model", "data", None)
    buf = DTensor.from_local(buf, mesh, pl(Partial(), Shard(0)),
                             run_check=False)
    y_buf = constrain_spec(_experts(p, constrain_spec(buf, spec)), spec)
    y_buf = y_buf.redistribute(mesh, pl(Replicate(), Shard(0))).to_local(
        grad_placements=pl(Partial(), Shard(0)))
    y_flat = DTensor.from_local(_gather(y_buf, plan), mesh,
                                pl(Shard(0), Partial()), run_check=False)
    gates = DTensor.from_local(plan.g_flat, mesh, pl(Shard(0), Replicate()),
                               run_check=False)
    y = _weigh(y_flat, gates, k)
    # laid out (and its gradient) as x, so the backward's merge of the
    # gradient into rows meets no second sharded dim
    y = constrain_spec(y.reshape(b, s, d), ("data", None, None))
    if "shared" in p:
        y = y + _shared(p, x)

    def mean(v):
        return DTensor.from_local(v / n_dp, mesh, pl(Partial(), Replicate()),
                                  run_check=False).redistribute(mesh, whole)
    return y, MoEMetrics(_aux(plan, e, mean), mean(plan.dropped_frac))
