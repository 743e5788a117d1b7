"""In-episode distillation, head-only (paper §3.4): per-camera head
params, AdamW state and the pair ring, and the cadence-gated update.

Per-camera independence: the loss is mapped per camera
(`torch.func.vmap`), the gradient is clipped by each camera's own norm,
and cameras whose ring is empty are a bit-exact no-op (a `torch.where`
on params and moments). The gradient is `torch.func.grad_and_value`,
which computes it also under an outer `torch.no_grad()`. Every update
returns new tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch
from torch.func import grad_and_value, vmap

from bench.reference import optim
from bench.reference.learn_loss import distill_head_loss
from bench.reference.learn_pairs import PairBuffer, init_pair_buffer
from bench.reference.optim import tree_leaves, tree_map


@dataclass(frozen=True)
class DistillSpec:
    """The distillation knobs this reference implements: head-only
    AdamW at a constant learning rate."""
    lr: float = 3e-3
    every: int = 1
    buffer: int = 8
    harvest: int = 2
    weight_decay: float = 0.0
    grad_clip: float | None = 1.0
    optimizer: str = "adamw"
    schedule: str = "constant"
    head_only: bool = True

    def __post_init__(self):
        if (self.optimizer, self.schedule, self.head_only) != (
                "adamw", "constant", True):
            raise ValueError("the reference implements head-only AdamW "
                             "at a constant learning rate only")


class LearnState(NamedTuple):
    """What rides the episode carry with distillation on.

    params: the trainable subtree with a leading fleet axis [F, ...] —
    the heads dict in head-only mode, the full detector params
    otherwise. staged/staged_widx hold the current step's inference
    payload between the observe and learn hooks of one step."""
    params: Any                 # [F, ...] per-camera trainable params
    opt: Any                    # AdamState | SGDState over `params`
    buf: PairBuffer
    staged: torch.Tensor        # [F, K, ...] this step's student payload
    staged_widx: torch.Tensor   # [F, K] int64 window ids of the payload


def init_learn(dspec: DistillSpec, det_cfg, det_params, n_cameras: int,
               shortlist_k: int, payload: tuple) -> LearnState:
    """Copy the heads per camera (fresh tensors) and size the ring and
    staging buffers for one crop's post-neck map `payload` (rows, cols,
    width)."""
    f = n_cameras
    params = tree_map(lambda p: p[None].expand((f,) + p.shape).clone(),
                      det_params["heads"])
    opt = optim.adamw_init(params, tree_map(lambda _: True, params))
    dev = tree_leaves(params)[0].device
    return LearnState(
        params=params, opt=opt,
        buf=init_pair_buffer(f, dspec.buffer, payload, det_cfg.max_boxes,
                             device=dev),
        staged=torch.zeros((f, shortlist_k) + payload, device=dev),
        staged_widx=torch.zeros((f, shortlist_k), dtype=torch.int64,
                                device=dev))


def lr_at(dspec: DistillSpec, step: torch.Tensor) -> torch.Tensor:
    """The float32 learning rate (constant schedule)."""
    return torch.full((), dspec.lr, dtype=torch.float32, device=step.device)


def _per_camera_clip(grads, mask, clip: float) -> Any:
    """Per-camera global-norm clip over the trainable leaves: each
    camera's row scales by its OWN norm, so no gradient information
    crosses the fleet axis."""
    sq = None
    for g, keep in zip(tree_leaves(grads), tree_leaves(mask)):
        if not keep:
            continue
        s = torch.sum(torch.square(g.float()), dim=tuple(range(1, g.ndim)))
        sq = s if sq is None else sq + s
    gnorm = torch.sqrt(sq)                                  # [F]
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    def app(g):
        return g * scale.reshape((g.shape[0],)
                                 + (1,) * (g.ndim - 1)).to(g.dtype)

    return tree_map(app, grads)


def distill_update(dspec: DistillSpec, det_cfg, lc: LearnState
                   ) -> tuple[LearnState, torch.Tensor]:
    """One optimizer step over every camera's ring. Returns (new state,
    per-camera loss [F] — -1.0 for cameras whose ring was empty and
    whose params/moments pass through bit-unchanged)."""
    buf = lc.buf
    f = buf.weight.shape[0]

    cam_loss = distill_head_loss
    def total(params):
        losses = vmap(cam_loss)(params, buf.x, buf.boxes, buf.classes,
                                buf.valid, buf.weight)
        return losses.sum(), losses

    grads, (_, losses) = grad_and_value(total, has_aux=True)(lc.params)
    mask = tree_map(lambda _: True, lc.params)
    if dspec.grad_clip is not None:
        grads = _per_camera_clip(grads, mask, dspec.grad_clip)
    lr_t = lr_at(dspec, lc.opt.step)
    new_params, new_opt = optim.adamw_update(
        lc.params, grads, lc.opt, lr=lr_t, mask=mask,
        weight_decay=dspec.weight_decay, grad_clip=None)

    # idle cameras (empty ring) are a bit-exact no-op: weight decay and
    # Adam moments must not drift params that saw no data
    has = buf.weight.sum(-1) > 0                            # [F]

    def keep_new(keep, n, o):
        if not keep:
            return n                    # masked leaves never changed
        return torch.where(has.reshape((f,) + (1,) * (n.ndim - 1)), n, o)

    new_params = tree_map(keep_new, mask, new_params, lc.params)
    new_opt = optim.AdamState(
        new_opt.step,
        tree_map(keep_new, mask, new_opt.mu, lc.opt.mu),
        tree_map(keep_new, mask, new_opt.nu, lc.opt.nu))
    loss_out = torch.where(has, losses.detach(), -1.0)
    return lc._replace(params=new_params, opt=new_opt), loss_out


def distill_step(dspec: DistillSpec, det_cfg, lc: LearnState, step: int
                 ) -> tuple[LearnState, dict]:
    """The cadence-gated update. `step` is the post-step controller step
    count as a host int (steps are 1-based after fleet_step increments
    them; the episode loop knows it, so the gate costs no read-back of
    the device's step_idx). Returns (state', aux) with aux {"loss": [F]
    (-1.0 on skipped/idle), "lr": [F]}."""
    f = lc.buf.weight.shape[0]
    if step % dspec.every == 0:
        lc, loss = distill_update(dspec, det_cfg, lc)
    else:
        loss = torch.full((f,), -1.0, device=lc.buf.weight.device)
    lr_t = lr_at(dspec, lc.opt.step)
    return lc, {"loss": loss, "lr": lr_t.reshape(()).expand(f).clone()}
