"""The in-episode learning loop: (trainable params, optimizer state, pair
ring) riding the episode carry.

`LearnState` rides the DetectorProvider carry; `distill_step` is the
optimizer step the episode takes after every controller step, on the
cadence DistillSpec.every sets. `finetune_update` is the host-side
continual-learning step (core/continual.finetune_step) over image
batches. The design constraints, in order:

  * one update rule — `optimizer_apply` is the single place an
    optimizer touches params (train/optim.py's AdamW / SGD), for the
    in-episode and the host-side step alike;
  * per-camera independence — the loss is mapped per camera
    (`torch.func.vmap`), gradient clipping is per camera (one global
    norm over all leaves would couple cameras through the fleet axis,
    so each row is clipped by its own norm), and cameras whose ring is empty are a bit-exact no-op (a
    `torch.where` on params AND moments: AdamW's weight decay would
    otherwise drift idle cameras' heads);
  * frozen-backbone exactness — head-only mode trains per-camera head
    convs on features the shared frozen backbone staged during the
    inference forward, so training adds only head-conv FLOPs.

The gradient is `torch.func.grad_and_value`, which computes it also
under the episode's outer `torch.no_grad()`; nothing else tracks
gradients. Every update returns new tensors: nothing writes into the
parameters or moments it was given.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.func import grad_and_value, vmap

from repro_torch.learn.loss import distill_full_loss, distill_head_loss
from repro_torch.learn.pairs import PairBuffer, init_pair_buffer
from repro_torch.learn.spec import DistillSpec
from repro_torch.models import detector as det
from repro_torch.models.layers import full_float32
from repro_torch.train import optim
from repro_torch.train.optim import tree_leaves, tree_map


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


def trainable_mask(dspec: DistillSpec, det_cfg, trainable) -> Any:
    """Optimizer mask over the trainable tree. Head-only: everything
    (the subtree IS the heads). Full: everything except the shared patch
    embedding — the staged tokens were produced by it, so its gradients
    are structurally zero and Adam/decay must not drift it."""
    m = tree_map(lambda _: True, trainable)
    if not dspec.head_only:
        pe = det.patch_embed_params(m, det_cfg)
        pe.update(tree_map(lambda _: False, pe))
    return m


def init_learn(dspec: DistillSpec, det_cfg, det_params, n_cameras: int,
               shortlist_k: int) -> LearnState:
    """Copy the trainable subtree per camera (fresh tensors: the shared
    params are never written through) and size the ring and staging
    buffers."""
    backbone = det.config_backbone(det_cfg)
    if not dspec.head_only and backbone != "vit":
        raise NotImplementedError(
            f"full-parameter distillation (DistillSpec(head_only=False)) "
            f"runs with the ViT backbone only, not {backbone!r}: use "
            f"head_only=True")
    f = n_cameras
    g = det.neck_grid(det_cfg)
    sub = det_params["heads"] if dspec.head_only else det_params
    params = tree_map(lambda p: p[None].expand((f,) + p.shape).clone(),
                      sub)
    mask = trainable_mask(dspec, det_cfg, params)
    if dspec.optimizer == "adamw":
        opt = optim.adamw_init(params, mask)
    else:
        opt = optim.sgd_init(params)
    if dspec.head_only:
        payload = (g, g, det_cfg.fpn_dim)
    else:
        payload = (g * g, det_cfg.d_model)
    dev = tree_leaves(params)[0].device
    return LearnState(
        params=params, opt=opt,
        buf=init_pair_buffer(f, dspec.buffer, payload, det_cfg.max_boxes,
                             device=dev),
        staged=torch.zeros((f, shortlist_k) + payload, device=dev),
        staged_widx=torch.zeros((f, shortlist_k), dtype=torch.int64,
                                device=dev))


def lr_at(dspec: DistillSpec, step) -> torch.Tensor:
    """The float32 learning rate at optimizer step `step`."""
    if dspec.schedule == "constant":
        # a fill on the step's device: no host-to-device copy (which
        # would wait for the device's queue)
        dev = step.device if isinstance(step, torch.Tensor) else None
        return torch.full((), dspec.lr, dtype=torch.float32, device=dev)
    return optim.cosine_schedule(dspec.lr, dspec.warmup,
                                 dspec.horizon)(step)


def optimizer_apply(name: str, params, grads, opt_state, *, lr,
                    mask=None, weight_decay: float = 0.0,
                    grad_clip: float | None = None):
    """THE optimizer update: every training path funnels into this one
    call. `grad_clip` is AdamW's global-norm clip (None: the gradients
    as given). Returns (params', opt_state')."""
    if name == "adamw":
        return optim.adamw_update(params, grads, opt_state, lr=lr,
                                  mask=mask, weight_decay=weight_decay,
                                  grad_clip=grad_clip)
    if name == "sgd":
        return optim.sgd_update(params, grads, opt_state, lr=lr)
    raise ValueError(f"unknown optimizer {name!r} (adamw | sgd)")


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

    if dspec.head_only:
        cam_loss = distill_head_loss
    else:
        def cam_loss(tr, x, bx, cl, vl, w):
            return distill_full_loss(tr, det_cfg, x, bx, cl, vl, w)

    def total(params):
        losses = vmap(cam_loss)(params, buf.x, buf.boxes, buf.classes,
                                buf.valid, buf.weight)
        return losses.sum(), losses

    grads, (_, losses) = grad_and_value(total, has_aux=True)(lc.params)
    mask = trainable_mask(dspec, det_cfg, lc.params)
    if dspec.grad_clip is not None:
        grads = _per_camera_clip(grads, mask, dspec.grad_clip)
    lr_t = lr_at(dspec, lc.opt.step)
    new_params, new_opt = optimizer_apply(
        dspec.optimizer, lc.params, grads, lc.opt, lr=lr_t, mask=mask,
        weight_decay=dspec.weight_decay)

    # idle cameras (empty ring) are a bit-exact no-op: weight decay and
    # Adam moments must not drift params that saw no data
    has = buf.weight.sum(-1) > 0                            # [F]

    def keep_new(keep, n, o):
        if not keep:
            return n                    # masked leaves never changed
        return torch.where(has.reshape((f,) + (1,) * (n.ndim - 1)), n, o)

    new_params = tree_map(keep_new, mask, new_params, lc.params)
    if dspec.optimizer == "adamw":
        new_opt = optim.AdamState(
            new_opt.step,
            tree_map(keep_new, mask, new_opt.mu, lc.opt.mu),
            tree_map(keep_new, mask, new_opt.nu, lc.opt.nu))
    else:
        new_opt = optim.SGDState(
            new_opt.step,
            tree_map(keep_new, mask, new_opt.momentum, lc.opt.momentum))
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


def merged_params(dspec: DistillSpec, det_params, trained, camera=None):
    """Recombine the per-camera trained subtree with the shared frozen
    rest into full detector params. camera=None keeps the leading fleet
    axis on the trained leaves (head-only mode then mixes the shared
    backbone with [F, ...] heads — select a camera before saving); an
    int selects one camera's checkpoint, ready for
    `save_detector_params`."""
    if camera is not None:
        trained = tree_map(lambda p: p[camera], trained)
    if dspec.head_only:
        return {"backbone": det_params["backbone"], "heads": trained}
    return trained


# ---------------------------------------------------------------------------
# host-side fine-tune (core/continual.py delegates here)
# ---------------------------------------------------------------------------

def finetune_update(params, opt_state, cfg, images, gt_boxes, gt_classes,
                    gt_valid, *, lr: float = 1e-3):
    """One host-side continual-learning step on an image batch: the
    detector loss with the backbone frozen (its features detached), the
    gradient clipped to a global norm of 1.0, then heads-only AdamW
    (weight decay 1e-4) through `optimizer_apply`, in full float32
    (`full_float32`). images [B, H, W, 3], gt_boxes [B, N, 4],
    gt_classes [B, N], gt_valid [B, N]. Returns (params', state',
    loss); the backbone leaves come back as the same tensors."""
    def loss_fn(p):
        return det.detector_loss(p, cfg, images, gt_boxes, gt_classes,
                                 gt_valid, freeze_backbone=True)

    with full_float32():
        grads, loss = grad_and_value(loss_fn)(params)
        params, opt_state = optimizer_apply(
            "adamw", params, grads, opt_state, lr=lr,
            mask=det.head_params_mask(params), weight_decay=1e-4,
            grad_clip=1.0)
    return params, opt_state, loss.detach()


def init_finetune_state(params):
    """AdamW state sized to the heads only (masked leaves keep 0-d
    moments)."""
    return optim.adamw_init(params, det.head_params_mask(params))
