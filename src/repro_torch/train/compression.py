"""Gradient compression with error feedback: int8 uniform quantization
with one float32 scale per tensor, and the quantization residual kept
locally and added back into the next step's gradient (EF-SGD), so the
compressor is a contraction and convergence is kept.

    qs, scales, state = compress(grads, state)
    deq = decompress(qs, scales)        # what crosses the slow link

The int8 payload is a quarter of float32's bytes and half of bf16's.
`crosspod_allreduce_compressed` averages the dequantized gradients over
the slow axis (`pod`): the mean of per-pod quantized gradients, each
pod's quantization error kept in its own EF state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import resolve_group
from repro_torch.train.optim import tree_map


class EFState(NamedTuple):
    error: object       # float32 residuals, the gradient tree's shapes


def init_ef(grad_like) -> EFState:
    return EFState(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grad_like))


def quantize_int8(x: torch.Tensor):
    """-> (q int8, scale float32 [])."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_leaf(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback compression of one gradient leaf: (q, scale,
    new_err) with g + err = dequantize(q, scale) + new_err."""
    corrected = g.float() + err
    q, scale = quantize_int8(corrected)
    new_err = corrected - dequantize_int8(q, scale)
    return q, scale, new_err


def compress(grads, state: EFState):
    """Tree-wise EF compression. Returns (qs, scales, new_state)."""
    out = tree_map(compress_leaf, grads, state.error)

    def pick(i):
        return tree_map(lambda t: t[i], out)

    return pick(0), pick(1), EFState(pick(2))


def decompress(qs, scales):
    return tree_map(dequantize_int8, qs, scales)


def crosspod_allreduce_compressed(grads, state: EFState, *, group):
    """EF-compressed mean over `group` (a ProcessGroup, or a (DeviceMesh,
    dim name) pair such as (mesh, "pod")).

    As the reference: each rank compresses its gradients with error
    feedback and dequantizes them; the all-reduce SUM carries those
    float32 values (what the reference's psum carries), and the sum is
    divided by the group size. Returns (mean tree, new EFState)."""
    g = resolve_group(group)
    qs, scales, state = compress(grads, state)
    deq = decompress(qs, scales)
    n = dist.get_world_size(g)

    def mean(x):
        dist.all_reduce(x, group=g)
        return x / n
    return tree_map(mean, deq), state
