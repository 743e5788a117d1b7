"""Hand-written optimizers (no torch.optim): AdamW with its global-norm
clip and SGD, both with masking, Adafactor (factored second moment), and
the cosine learning-rate schedule — the reference's formulas, one for
one, in float32 on parameter dictionaries.

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


def _donated(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """`new`'s values written into `old` where shape and dtype allow
    (returns old), else `new`."""
    if new is not old and new.shape == old.shape and new.dtype == old.dtype:
        return old.copy_(new)
    return new


def global_norm(grads: Params) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order) of each leaf's
    float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


def adamw_update(params: Params, grads: Params, state: AdamState, *,
                 lr: float | torch.Tensor = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, mask: Params | None = None,
                 grad_clip: float | None = 1.0, donate: bool = False):
    """Returns (new_params, new_state). Masked leaves pass through.
    With `grad_clip`, every gradient (masked leaves' too) is first scaled
    by min(1, grad_clip / max(global norm, 1e-9)), the scale rounded to
    the gradient's dtype; None takes the gradients as given
    (distillation clips them per camera before this call,
    learn/loop.py `_per_camera_clip`). The scaled gradients are formed a
    leaf at a time, inside the update, so no second gradient tree is
    held. With `donate`, each leaf's new parameter and moments are
    written into the given tensors as soon as they are computed, where
    shapes and dtypes allow (the moments of a bf16 model become float32
    at the first step, and are new tensors then), so the update holds
    one copy of the state instead of two; the caller gives its
    parameters and state up (as a JAX program's donated buffers) and
    must not read them again. The gradients are never written."""
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
        if donate:
            return (_donated(p, new_p), _donated(mu_old, mu),
                    _donated(nu_old, nu))
        return new_p, mu, nu

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


class AdafactorState(NamedTuple):
    step: torch.Tensor      # [] int32
    vr: Params              # row factors, shape[:-1] (rank >= 2 leaves)
    vc: Params              # column factors, shape[:-2] + shape[-1:]
    v: Params               # full second moment of rank < 2 leaves


def adafactor_init(params: Params) -> AdafactorState:
    """Float32 zeros: a [..., n, m] leaf keeps its row and column factors
    (n + m floats) and a 0-d v, a rank < 2 leaf the full v and 0-d
    factors."""
    def zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def row(p):
        return zeros(p.shape[:-1] if p.ndim >= 2 else (), p)

    def col(p):
        return zeros(p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (), p)

    def full(p):
        return zeros(p.shape if p.ndim < 2 else (), p)

    dev = tree_leaves(params)[0].device
    return AdafactorState(torch.zeros((), dtype=torch.int32, device=dev),
                          tree_map(row, params), tree_map(col, params),
                          tree_map(full, params))


def adafactor_update(params: Params, grads: Params, state: AdafactorState,
                     *, lr: float | torch.Tensor = 1e-3, decay: float = 0.8,
                     eps: float = 1e-30, clip_rms: float = 1.0,
                     donate: bool = False):
    """Adafactor (Shazeer & Stern 2018) without a first moment:
    beta = 1 - step^-decay, the factored (or, below rank 2, full) second
    moment of g^2 + eps, the update clipped to an RMS of `clip_rms`,
    applied in float32 and cast back to each parameter's dtype; `donate`
    as for `adamw_update`. Returns (new_params, new_state)."""
    step = state.step + 1
    beta = 1.0 - step.float() ** (-decay)

    def upd(p, g, vr_old, vc_old, v_old):
        vr, vc, v = vr_old, vc_old, v_old
        g32 = g.float()
        g2 = torch.square(g32) + eps
        if p.ndim >= 2:
            vr = beta * vr + (1 - beta) * g2.mean(-1)
            vc = beta * vc + (1 - beta) * g2.mean(-2)
            r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=eps)
            update = g32 / (torch.sqrt(r)[..., None]
                            * torch.sqrt(vc)[..., None, :] + 1e-12)
        else:
            v = beta * v + (1 - beta) * g2
            update = g32 / (torch.sqrt(v) + 1e-12)
        rms = torch.sqrt(torch.mean(torch.square(update)) + 1e-12)
        update = update / torch.clamp(rms / clip_rms, min=1.0)
        new_p = (p.float() - lr * update).to(p.dtype)
        if donate:
            return (_donated(p, new_p), _donated(vr_old, vr),
                    _donated(vc_old, vc), _donated(v_old, v))
        return new_p, vr, vc, v

    out = tree_map(upd, params, grads, state.vr, state.vc, state.v)

    def pick(i):
        return tree_map(lambda t: t[i], out)

    return pick(0), AdafactorState(step, pick(1), pick(2), pick(3))


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
