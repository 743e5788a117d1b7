"""Hand-written AdamW (no torch.optim) with its global-norm clip and
masking, in float32 on parameter dictionaries.

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

from typing import Any, NamedTuple

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


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order) of each leaf's
    float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


def adamw_update(params: Params, grads: Params, state: AdamState, *,
                 lr: float | torch.Tensor = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, mask: Params | None = None,
                 grad_clip: float | None = 1.0):
    """Returns (new_params, new_state). Masked leaves pass through.
    With `grad_clip`, every gradient (masked leaves' too) is first scaled
    by min(1, grad_clip / max(global norm, 1e-9)), the scale rounded to
    the gradient's dtype; None takes the gradients as given
    (distillation clips them per camera before this call,
    learn/loop.py `_per_camera_clip`). The scaled gradients are formed a
    leaf at a time, inside the update, so no second gradient tree is
    held. The gradients are never written."""
    m = _mask_like(params, mask)
    step = state.step + 1
    scale = None
    if grad_clip is not None:
        scale = torch.clamp(grad_clip / torch.clamp(global_norm(grads),
                                                    min=1e-9), max=1.0)

    # float32 powers of the step; the bases are fills on the step's
    # device (a host-to-device copy would wait for the device's queue)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.full_like(stepf, b1), stepf)
    b2c = 1 - torch.pow(torch.full_like(stepf, b2), stepf)

    def upd(p, g, mu_old, nu_old, keep):
        # mu = b1 mu + (1 - b1) g; nu = b2 nu + (1 - b2) g^2;
        # delta = (mu / b1c) / (sqrt(nu / b2c) + eps) [+ wd p];
        # p - lr delta: each op rounded as written (in-place only on
        # temporaries made here, which keeps a leaf's float32
        # temporaries to two besides its new moments)
        if not keep:
            return p, mu_old, nu_old
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.float()
        mu = (g32 * (1 - b1)).add_(b1 * mu_old)
        nu = torch.square(g32).mul_(1 - b2).add_(b2 * nu_old)
        del g, g32
        den = (nu / b2c).sqrt_().add_(eps)
        delta = (mu / b1c).div_(den)
        del den
        if weight_decay:
            delta.add_(p.to(torch.float32, copy=True).mul_(weight_decay))
        new_p = delta.mul_(lr).neg_().add_(p).to(p.dtype)
        return new_p, mu, nu

    out = tree_map(upd, params, grads, state.mu, state.nu, m)

    def pick(i):
        return tree_map(lambda t: t[i], out)

    return pick(0), AdamState(step, pick(1), pick(2))
