"""Hand-written optimizers (no torch.optim): AdamW and SGD with masking,
and the cosine learning-rate schedule — the reference's formulas, one
for one, in float32 on parameter dictionaries.

Masking is load-bearing for MadEye's continual learning: only the
leaves the mask keeps get Adam state (a masked leaf keeps a 0-d moment
and passes through untouched), so a frozen backbone stays
bit-identical. Every update is functional: it returns new tensors and
never writes into the ones it was given.

Trees are nested dictionaries of tensors; `tree_leaves` walks them in
sorted-key order (the reference's leaf order), which fixes the order
of every sum over leaves.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

Params = Any


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts and lists (`rest` share tree's
    structure; an MoE LM's dense layers are a list)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts (in sorted-key order) and lists."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


class AdamState(NamedTuple):
    step: torch.Tensor      # [] int32
    mu: Params
    nu: Params


def _mask_like(params: Params, mask: Params | None) -> Params:
    if mask is None:
        return tree_map(lambda _: True, params)
    return mask


def adamw_init(params: Params, mask: Params | None = None) -> AdamState:
    m = _mask_like(params, mask)

    def zeros(p, keep):
        return (torch.zeros_like(p) if keep
                else torch.zeros((), dtype=p.dtype, device=p.device))

    dev = tree_leaves(params)[0].device
    return AdamState(torch.zeros((), dtype=torch.int32, device=dev),
                     tree_map(zeros, params, m), tree_map(zeros, params, m))


def adamw_update(params: Params, grads: Params, state: AdamState, *,
                 lr: float | torch.Tensor = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, mask: Params | None = None):
    """Returns (new_params, new_state). Masked leaves pass through.
    Gradients are taken as given: distillation clips them per camera
    before this call (learn/loop.py `_per_camera_clip`)."""
    m = _mask_like(params, mask)
    step = state.step + 1

    # float32 powers of the step; the bases are fills on the step's
    # device (a host-to-device copy would wait for the device's queue)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.full_like(stepf, b1), stepf)
    b2c = 1 - torch.pow(torch.full_like(stepf, b2), stepf)

    def upd(p, g, mu, nu, keep):
        if not keep:
            return p, mu, nu
        g32 = g.float()
        mu = b1 * mu + (1 - b1) * g32
        nu = b2 * nu + (1 - b2) * torch.square(g32)
        mhat = mu / b1c
        nhat = nu / b2c
        delta = mhat / (torch.sqrt(nhat) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    out = tree_map(upd, params, grads, state.mu, state.nu, m)

    def pick(i):
        return tree_map(lambda t: t[i], out)

    return pick(0), AdamState(step, pick(1), pick(2))


class SGDState(NamedTuple):
    step: torch.Tensor      # [] int32
    momentum: Params


def sgd_init(params: Params) -> SGDState:
    dev = tree_leaves(params)[0].device
    return SGDState(torch.zeros((), dtype=torch.int32, device=dev),
                    tree_map(torch.zeros_like, params))


def sgd_update(params: Params, grads: Params, state: SGDState, *,
               lr: float | torch.Tensor = 0.1, momentum: float = 0.9):
    def upd(p, g, m):
        m = momentum * m + g.to(m.dtype)
        return (p.float() - lr * m.float()).to(p.dtype), m

    out = tree_map(upd, params, grads, state.momentum)
    return (tree_map(lambda t: t[0], out),
            SGDState(state.step + 1, tree_map(lambda t: t[1], out)))


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warm-up over `warmup` steps, then a cosine from base_lr to
    0 at `total`; returns step -> float32 learning rate."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr
