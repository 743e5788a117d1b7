"""The train-step factory for every architecture family: the dense and
MoE LMs, ViT, Swin, DiT, the MMDiT and the MadEye detector.

`make_train_step(cfg)` returns a TrainStep whose
`step(params, opt, batch, key) -> (params', opt', {"loss", "grad_norm"})`
takes the gradient of the family's loss (each runs its plain attention,
as the reference's losses do, so no kernel is launched) and applies
AdamW (global-norm clip built in) or Adafactor. `key` is a threefry key
(scene/prng.py); the diffusion losses draw their timesteps and noise
from it.

Gradient accumulation follows the reference's scan over a leading
microbatch axis: with `microbatches` > 1 the batch is [microbatches, mb,
...], the keys are `prng.split(key, microbatches)`, the per-microbatch
gradients are summed into float32 zeros and divided by `microbatches`
(so bf16 parameters hand the optimizer float32 gradients, and AdamW's
moments become float32 after its first step, as in the reference), the
loss is the mean of theirs, and grad_norm is the norm of the unclipped
mean gradient.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import (
    DetectorConfig,
    DiffusionConfig,
    LMConfig,
    VisionConfig,
)
from repro_torch.devices import resolve_device
from repro_torch.models import detector as det_mod
from repro_torch.models import diffusion as diff
from repro_torch.models import dit as dit_mod
from repro_torch.models import mmdit as mmdit_mod
from repro_torch.models import moe_lm, swin as swin_mod, transformer
from repro_torch.models import vit as vit_mod
from repro_torch.models.layout import TensorSpec  # noqa: F401 (re-exported)
from repro_torch.models.mmdit import TXT_TOKENS
from repro_torch.scene import prng
from repro_torch.train import optim
from repro_torch.train.optim import tree_leaves, tree_map


@dataclass(frozen=True)
class TrainStep:
    init_params: Callable        # (gen, device=None) -> params
    init_opt: Callable           # params -> opt_state
    step: Callable               # (params, opt, batch, key) -> (p, o, metrics)
    batch_spec: Callable         # shape -> {name: TensorSpec}


def _loss_for(cfg) -> Callable:
    if isinstance(cfg, LMConfig):
        if cfg.moe_experts:
            return lambda p, b, k: moe_lm.moe_lm_loss(
                p, cfg, b["tokens"], b["labels"])
        return lambda p, b, k: transformer.lm_loss(
            p, cfg, b["tokens"], b["labels"])
    if isinstance(cfg, VisionConfig):
        if cfg.swin:
            return lambda p, b, k: swin_mod.swin_loss(
                p, cfg, b["images"], b["labels"])
        return lambda p, b, k: vit_mod.vit_loss(
            p, cfg, b["images"], b["labels"])
    if isinstance(cfg, DiffusionConfig):
        if cfg.is_mmdit:
            return lambda p, b, k: diff.rf_train_loss(
                p, cfg, b["latents"], b["txt_emb"], k)
        return lambda p, b, k: diff.dit_train_loss(
            p, cfg, b["latents"], b["labels"], k)
    if isinstance(cfg, DetectorConfig):
        return lambda p, b, k: det_mod.detector_loss(
            p, cfg, b["images"], b["gt_boxes"], b["gt_classes"],
            b["gt_valid"])
    raise TypeError(type(cfg))


def _init_for(cfg) -> Callable:
    """(gen, device=None) -> fresh parameters: `gen` a torch.Generator
    (drawn on its device) or a numpy Generator; `device` the card unless
    the caller passes "cpu"."""
    if isinstance(cfg, LMConfig):
        init = moe_lm.moe_lm_init if cfg.moe_experts else transformer.lm_init
        return lambda gen, device=None: init(gen, cfg, device)
    if isinstance(cfg, VisionConfig):
        init = swin_mod.swin_init if cfg.swin else vit_mod.vit_init
        return lambda gen, device=None: init(gen, cfg, device=device)
    if isinstance(cfg, DiffusionConfig):
        init = mmdit_mod.mmdit_init if cfg.is_mmdit else dit_mod.dit_init
        return lambda gen, device=None: init(gen, cfg, device)
    if isinstance(cfg, DetectorConfig):
        return lambda gen, device=None: det_mod.detector_init(
            gen, cfg, device=resolve_device(device))
    raise TypeError(type(cfg))


def batch_specs(cfg, shape, *, microbatches: int = 1) -> dict:
    """{name: TensorSpec} of the training batch at `shape` (a
    ShapeSpec), with a leading [microbatches, mb] when microbatches > 1
    and [global_batch] otherwise."""
    b = shape.global_batch
    assert b % microbatches == 0
    mb = b // microbatches
    lead = (microbatches, mb) if microbatches > 1 else (b,)

    def spec(s, dt):
        return TensorSpec(lead + s, dt)

    if isinstance(cfg, LMConfig):
        s = shape.seq_len
        return {"tokens": spec((s,), torch.int32),
                "labels": spec((s,), torch.int32)}
    if isinstance(cfg, VisionConfig):
        r = shape.img_res
        return {"images": spec((r, r, 3), torch.float32),
                "labels": spec((), torch.int32)}
    if isinstance(cfg, DiffusionConfig):
        r = (cfg.latent_res if cfg.latent_res else shape.img_res // 8)
        if shape.img_res and cfg.latent_res:
            # latent res scales with the shape's image resolution
            r = cfg.latent_res * shape.img_res // cfg.img_res
        d = {"latents": spec((r, r, cfg.latent_channels), torch.float32)}
        if cfg.is_mmdit:
            d["txt_emb"] = spec((TXT_TOKENS, cfg.cond_dim), torch.float32)
        else:
            d["labels"] = spec((), torch.int32)
        return d
    if isinstance(cfg, DetectorConfig):
        r = cfg.img_res
        n = cfg.max_boxes
        return {"images": spec((r, r, 3), torch.float32),
                "gt_boxes": spec((n, 4), torch.float32),
                "gt_classes": spec((n,), torch.int32),
                "gt_valid": spec((n,), torch.bool)}
    raise TypeError(type(cfg))


def value_and_grad(loss_fn: Callable, params, *args):
    """(loss, gradients) of loss_fn(params, *args) with respect to every
    leaf of `params` (a leaf the loss does not reach gets zeros, as a
    stop_gradient gives in the reference); the tensors of `params` are
    neither copied nor marked."""
    with torch.enable_grad():
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = loss_fn(p, *args)
        flat = tree_leaves(p)
        gs = torch.autograd.grad(loss, flat, allow_unused=True,
                                 materialize_grads=True)
    by_leaf = {id(t): _as_param(g, t) for t, g in zip(flat, gs)}
    return loss.detach(), tree_map(lambda t: by_leaf[id(t)], p)


def _as_param(g, param):
    """A DTensor gradient laid out as its parameter (ZeRO: reduced and
    scattered to the parameter's shards, as GSPMD lays gradients out);
    plain gradients as they are."""
    if isinstance(g, DTensor) and g.placements != param.placements:
        return g.redistribute(param.device_mesh, param.placements)
    return g


def make_train_step(cfg, *, lr: float = 1e-4, weight_decay: float = 0.01,
                    microbatches: int = 1, grad_clip: float | None = 1.0,
                    param_mask=None, optimizer: str = "adamw",
                    donate: bool = False) -> TrainStep:
    """optimizer: "adamw" (moments in the parameters' dtype until the
    first float32 gradient arrives, the global-norm clip `grad_clip`) or
    "adafactor" (factored float32 second moment; no clip, as the
    reference's). With `donate`, step writes the new parameters and
    optimizer state into the tensors it was given (optim.adamw_update's
    `donate`): one copy of the state in memory instead of two, for a
    caller that never reads a step's inputs again (the launcher's
    loop)."""
    if optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {optimizer!r} "
                         "(adamw | adafactor)")
    loss_fn = _loss_for(cfg)

    def init_opt(params):
        if optimizer == "adafactor":
            return optim.adafactor_init(params)
        return optim.adamw_init(params, param_mask)

    def step(params, opt_state, batch, key):
        if microbatches > 1:
            keys = prng.split(key, microbatches)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses = []
            for i in range(microbatches):
                loss_i, g = value_and_grad(
                    loss_fn, params, {k: v[i] for k, v in batch.items()},
                    keys[i])
                tree_map(lambda s, gi: s.add_(gi), grads, g)
                del g
                losses.append(loss_i)
            tree_map(lambda s: s.div_(microbatches), grads)
            loss = torch.stack(losses).mean()
        else:
            loss, grads = value_and_grad(loss_fn, params, batch, key)
        gnorm = optim.global_norm(grads)

        if optimizer == "adafactor":
            params, opt_state = optim.adafactor_update(
                params, grads, opt_state, lr=lr, donate=donate)
        else:
            params, opt_state = optim.adamw_update(
                params, grads, opt_state, lr=lr, weight_decay=weight_decay,
                mask=param_mask, grad_clip=grad_clip, donate=donate)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return TrainStep(
        init_params=_init_for(cfg),
        init_opt=init_opt,
        step=step,
        batch_spec=partial(batch_specs, cfg, microbatches=microbatches),
    )
