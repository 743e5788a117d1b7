"""Collectives with explicit schedules, on torch.distributed groups.

Where the reference calls these inside `shard_map` with an `axis_name`,
each function here takes `group`: a ProcessGroup, or a (DeviceMesh, dim
name) pair naming the mesh dim's group that holds this rank.

  * `psum_scatter_grads` — reduce-scatter gradients along dim 0 (each
    rank keeps only its shard — the ZeRO-2/3 wire pattern);
  * `ring_allgather` — all-gather as N-1 ring steps of point-to-point
    sends, so a caller can overlap each step's transfer with work on the
    chunk already in hand;
  * `ring_reduce_attend` — decode attention over a sequence-sharded KV
    cache: local partial softmax, then three small all-reduces instead
    of gathering the cache;
  * `gather_fleet` — the fleet's rank-local outputs back to global ones
    (fleet/runner.py);
  * `crosspod_allreduce_compressed` lives in train/compression.py.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import tree_map_with_path


def resolve_group(group):
    """A ProcessGroup, or the group of a (DeviceMesh, dim name) pair."""
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    return group


def psum_scatter_grads(grads, group):
    """Reduce-scatter every gradient leaf along dim 0 when the group size
    divides it (this rank keeps its [shape[0]/n, ...] slice of the sum);
    all-reduce it whole otherwise."""
    g = resolve_group(group)
    n = dist.get_world_size(g)

    def leaf(_, x):
        if x.ndim and x.shape[0] % n == 0:
            out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
            dist.reduce_scatter_tensor(out, x.contiguous(), group=g)
            return out
        out = x.clone()
        dist.all_reduce(out, group=g)
        return out
    return tree_map_with_path(leaf, grads)


def ring_allgather(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather by N-1 ring steps (send to the next rank, receive from
    the previous). Returns [N, ...] with rank r's x in slot r: the chunk
    received at step i came from rank (idx - i) % N, the reference's slot
    order."""
    g = resolve_group(group)
    n = dist.get_world_size(g)
    idx = dist.get_rank(g)
    to_rank = dist.get_global_rank(g, (idx + 1) % n)
    from_rank = dist.get_global_rank(g, (idx - 1) % n)
    buf = x.new_empty((n,) + tuple(x.shape))
    cur = x.contiguous()
    for i in range(n):
        buf[(idx - i) % n] = cur
        if i == n - 1:
            break
        nxt = torch.empty_like(cur)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, cur, to_rank, g),
            dist.P2POp(dist.irecv, nxt, from_rank, g)])
        for r in reqs:
            r.wait()
        cur = nxt
    return buf


def ring_reduce_attend(q, k_shard, v_shard, group, *, scale: float):
    """Decode attention over a sequence-sharded KV cache.

    q [B, 1, H, D]; k_shard / v_shard [B, S/n, H, D] (this rank's
    chunk). Each rank computes its partial (max, denominator, weighted
    V) over its chunk in float32; an all-reduce MAX and two all-reduce
    SUMs combine them into the exact softmax. Returns [B, 1, H, D] in
    q's dtype."""
    g = resolve_group(group)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_shard.float()) * scale
    m = s.amax(-1, keepdim=True)                                # [B,H,1,1]
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=g)
    p = torch.exp(s - m)
    denom = p.sum(-1, keepdim=True)
    dist.all_reduce(denom, group=g)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v_shard.float())
    dist.all_reduce(o, group=g)
    o = o / torch.clamp(denom.transpose(1, 2), min=1e-20)
    return o.to(q.dtype)


def gather_fleet(tree, group, axis: int = 0):
    """Concatenate every rank's leaves along `axis` in group-rank order
    (all_gather), for each leaf with more than `axis` dims; lower-rank
    leaves (a scalar optimizer step every rank holds alike) pass through.

    Over a gloo group a CUDA tensor travels through a CPU copy: gloo's
    collectives take CPU tensors."""
    g = resolve_group(group)
    n = dist.get_world_size(g)
    via_host = dist.get_backend(g) == "gloo"

    def leaf(_, x):
        if x.ndim <= axis:
            return x
        src = x.detach().contiguous()
        if via_host:
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=g)
        return torch.cat(parts, dim=axis).to(x.device)
    return tree_map_with_path(leaf, tree)
