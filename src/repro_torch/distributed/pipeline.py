"""Pipeline parallelism: stage-sharded layer stacks with a GPipe
microbatch rotation over point-to-point sends.

The stage axis is a mesh dim (`model` by default): each rank along it
owns n_layers / S contiguous layers, and the microbatch stream moves
through the stages:

  stage s at step t runs microbatch t - s; after M + S - 1 steps every
  microbatch has crossed every stage (GPipe fill and drain, forward
  only).

Exact: the outputs equal running the layers in sequence on each
microbatch (tests/test_torch_distributed.py), since every stage runs
the same layer bodies on the same values, only on another rank.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import resolve_group
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.layers import layer_params
from repro_torch.train.optim import tree_leaves, tree_map


def split_stages(stacked_params, n_stages: int):
    """[L, ...] stacked layer params -> [S, L/S, ...] stage-major (views)."""
    def leaf(x):
        n_layers = x.shape[0]
        if n_layers % n_stages:
            raise ValueError(f"{n_layers} layers do not split into "
                             f"{n_stages} stages")
        return x.reshape((n_stages, n_layers // n_stages)
                         + tuple(x.shape[1:]))
    return tree_map(leaf, stacked_params)


def _stage_apply(body: Callable, stage_params, x, extra):
    """Run this rank's layer slice in sequence."""
    for i in range(tree_leaves(stage_params)[0].shape[0]):
        x = body(layer_params(stage_params, i), x, extra)
    return x


def pipeline_forward(body: Callable, stage_params, x_micro, *, extra=None,
                     group):
    """Run microbatches through the pipeline stages of `group` (a
    ProcessGroup or a (DeviceMesh, dim name) pair; stage = group rank).

    stage_params: this rank's stage, [L/S, ...] per leaf; x_micro [M, mb,
    ...], the same on every rank; body(layer_params, x, extra) -> x.
    Returns [M, mb, ...] on every rank.

    Stage 0 injects microbatch t at step t; a stage runs its layers while
    it holds a real microbatch (s <= t < s + M) and sends the result to
    stage s + 1; the last stage writes microbatch t - S + 1. A masked
    all-reduce then broadcasts the outputs from the last stage."""
    g = resolve_group(group)
    n_st = dist.get_world_size(g)
    s = dist.get_rank(g)
    m = x_micro.shape[0]
    outputs = torch.zeros_like(x_micro)
    cur = torch.zeros_like(x_micro[0])
    for t in range(m + n_st - 1):
        if s == 0:
            cur = x_micro[t if t < m else 0]
        active = s <= t < s + m
        y = _stage_apply(body, stage_params, cur, extra) if active else cur
        if s == n_st - 1 and t >= n_st - 1:
            outputs[t - n_st + 1] = y
        # boundary activations move one stage forward: a stage sends what
        # it computed, and receives what the stage before it computed
        ops, nxt = [], None
        if s < n_st - 1 and active:
            ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                  dist.get_global_rank(g, s + 1), g))
        if s > 0 and s - 1 <= t < s - 1 + m:
            nxt = torch.empty_like(cur)
            ops.append(dist.P2POp(dist.irecv, nxt,
                                  dist.get_global_rank(g, s - 1), g))
        if ops:
            for r in dist.batch_isend_irecv(ops):
                r.wait()
        if nxt is not None:
            cur = nxt
    if s != n_st - 1:
        outputs.zero_()
    dist.all_reduce(outputs, group=g)
    return outputs


def make_pipelined_forward(body: Callable, mesh, n_stages: int, *,
                           axis_name: str = "model"):
    """Wrap a layer body into a pipelined forward over the mesh dim
    `axis_name` (its size must be n_stages).

    Returns fn(stage_params [S, L/S, ...], x_micro [M, mb, ...],
    extra=None) -> [M, mb, ...]: it takes the whole stage-major tree (as
    `split_stages` gives it) and runs this rank's stage."""
    size = mesh_shape(mesh)[axis_name]
    if size != n_stages:
        raise ValueError(f"mesh dim {axis_name!r} has {size} ranks, not "
                         f"{n_stages} stages")
    group = mesh.get_group(axis_name)
    stage = mesh.get_local_rank(axis_name)

    def fn(stage_params, x_micro, extra=None):
        mine = tree_map(lambda p: p[stage], stage_params)
        return pipeline_forward(body, mine, x_micro, extra=extra,
                                group=group)
    return fn
