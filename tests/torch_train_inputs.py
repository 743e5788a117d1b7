"""Seeded numpy weights and batches for one train step of every family's
SMOKE config, and the comparison of two such steps with the stated
tolerances. Imports numpy and the port only, so the card-only tests run
it where JAX is not installed.

Tolerances of one step (`check_step`; `make_train_step`'s defaults:
AdamW, lr 1e-4, weight decay 0.01, global-norm clip 1.0):

- loss and grad_norm: 1e-5 relative in float32 (sums in another order);
  2e-3 in bf16 (the bf16 products round where the order of their sums
  puts them; measured at most 3.7e-4 / 5.1e-4 against the reference);
- parameters: AdamW's first step is lr * g / (|g| + 1e-8), about lr *
  sign(g): an element whose (clipped) gradient is at round-off level,
  |g| < 1e-7, may step by up to ~lr either way on either side, so those
  are held to 3 lr, and those not exactly 0 (an embedding row no token
  reaches) must be at most 2% of the elements; every other
  float32 element to 1e-6. In a bf16 model the gradients carry bf16
  round-off (a few ulps through the layers) and a bf16 parameter rounds
  its update: every element is held to one bf16 ulp (2^-7 of the value)
  or 3 lr, and at most 2% of them may differ by more than 1e-6
  (measured at most 0.81%, deepseek-v3);
- AdamW's moments: float32 after the step on both sides, mu and nu
  within 1e-5 (float32) and 4e-2 (bf16; measured at most 2.0e-2) of the
  tree's largest.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.train import trainer
from repro_torch.train.optim import tree_leaves, tree_map
from torch_zoo_weights import perturb_numpy

TRAIN_ARCHS = ["stablelm-3b", "deepseek-v3-671b", "vit-b16", "swin-b",
               "dit-l2", "flux-dev", "madeye-approx"]
BATCH, SEQ = 4, 16
LR = 1e-4                   # make_train_step's default
B1 = 0.9
ROUNDOFF = 1e-7             # |clipped gradient| at round-off level
BF16_ULP = 2.0 ** -7
LOSS_REL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}
PARAM_ABS = 1e-6            # float32 elements off round-off
ROUGH_SHARE = 0.02
BF16_FLIP_SHARE = 0.02
MOMENT_REL = {torch.float32: 1e-5, torch.bfloat16: 4e-2}


def smoke(arch: str, dtype: torch.dtype | None = None):
    """arch's SMOKE config, in `dtype` where the family has one (the
    detector is float32)."""
    cfg = get_smoke_config(arch)
    if dtype is not None and hasattr(cfg, "dtype"):
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg


def train_params(cfg, seed: int = 0, device="cpu"):
    """cfg's parameters drawn by numpy through the port's init (the same
    under any PyTorch), every leaf perturbed off its init
    (torch_zoo_weights.perturb_numpy), in the init's dtypes, on
    `device`."""
    init = trainer.make_train_step(cfg).init_params(
        np.random.default_rng(seed), "cpu")
    pert = perturb_numpy(init, np.random.default_rng(seed + 1000))
    return tree_map(lambda i, a: torch.as_tensor(a).to(device=device,
                                                       dtype=i.dtype),
                    init, pert)


def train_shape(cfg) -> ShapeSpec:
    if cfg.family == "lm":
        return ShapeSpec("t", "train", seq_len=SEQ, global_batch=BATCH)
    return ShapeSpec("t", "train", img_res=cfg.img_res, global_batch=BATCH)


def numpy_batch(cfg, microbatches: int = 1, seed: int = 5) -> dict:
    """A batch of trainer.batch_specs drawn by numpy: integers below the
    vocabulary or class count, images uniform in [0, 1], boxes in [0.05,
    0.95], valid flags at 60%, other floats standard normal; with
    microbatches > 1 the leading [BATCH] axis becomes [microbatches,
    BATCH / microbatches]."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in trainer.batch_specs(cfg, train_shape(cfg)).items():
        if s.dtype == torch.int32:
            hi = getattr(cfg, "vocab", getattr(cfg, "n_classes", 2))
            a = rng.integers(0, hi, s.shape).astype(np.int32)
        elif s.dtype == torch.bool:
            a = rng.uniform(size=s.shape) < 0.6
        elif k == "gt_boxes":
            a = rng.uniform(0.05, 0.95, s.shape).astype(np.float32)
        elif k == "images":
            a = rng.uniform(0, 1, s.shape).astype(np.float32)
        else:
            a = rng.normal(0, 1, s.shape).astype(np.float32)
        if microbatches > 1:
            a = a.reshape((microbatches, a.shape[0] // microbatches)
                          + a.shape[1:])
        out[k] = a
    return out


def torch_batch(batch: dict, device="cpu") -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def check_step(got, want, dtype: torch.dtype, label: str) -> dict:
    """Hold one AdamW train step's outputs `got` = (params, opt,
    metrics) against `want` (the same, as CPU tensors) with the module's
    tolerances; raises AssertionError naming `label`. Returns the worst
    errors (loss and grad_norm relative, params absolute, the rough and
    flipped shares)."""
    gp, go, gm = got
    wp, wo, wm = want

    def f32(t):
        return t.detach().cpu().float()

    out = {}
    for k in ("loss", "grad_norm"):
        out[k] = abs(float(gm[k]) - float(wm[k])) / abs(float(wm[k]))
        if not out[k] <= LOSS_REL[dtype]:
            raise AssertionError(f"{label}: {k} {float(gm[k])} vs "
                                 f"{float(wm[k])}")
    for which, gl, wl in (("mu", go.mu, wo.mu), ("nu", go.nu, wo.nu)):
        top = max(float(f32(w).abs().max()) for w in tree_leaves(wl))
        err = 0.0
        for g, w in zip(tree_leaves(gl), tree_leaves(wl)):
            if g.dtype != torch.float32 or w.dtype != torch.float32:
                raise AssertionError(f"{label}: {which} {g.dtype} vs "
                                     f"{w.dtype}, want float32")
            err = max(err, float((f32(g) - f32(w)).abs().max()))
        out[which] = err / top
        if out[which] > MOMENT_REL[dtype]:
            raise AssertionError(f"{label}: {which} off by {err:.3e} of "
                                 f"{top:.3e}")
    worst, n_rough, n_flip, n_all = 0.0, 0, 0, 0
    for g, w, mu in zip(tree_leaves(gp), tree_leaves(wp),
                        tree_leaves(wo.mu)):
        if g.dtype != w.dtype:
            raise AssertionError(f"{label}: param dtype {g.dtype} vs "
                                 f"{w.dtype}")
        err = (f32(g) - f32(w)).abs()
        g_ref = (f32(mu) / (1 - B1)).abs()
        rough = g_ref < ROUNDOFF
        if dtype == torch.bfloat16:
            ok = err <= torch.clamp(BF16_ULP * f32(w).abs(), min=3 * LR)
            n_flip += int((err > PARAM_ABS).sum())
        else:
            ok = torch.where(rough, err <= 3 * LR, err <= PARAM_ABS)
        if not bool(ok.all()):
            raise AssertionError(f"{label}: a {tuple(w.shape)} parameter "
                                 f"off by {float(err.max()):.3e}")
        worst = max(worst, float(err.max()))
        n_rough += int((rough & (g_ref > 0)).sum())
        n_all += err.numel()
    out.update(params=worst, rough_share=n_rough / n_all,
               flip_share=n_flip / n_all)
    if out["rough_share"] > ROUGH_SHARE:
        raise AssertionError(f"{label}: {n_rough} of {n_all} gradients at "
                             "round-off")
    if out["flip_share"] > BF16_FLIP_SHARE:
        raise AssertionError(f"{label}: {n_flip} of {n_all} bf16 "
                             "parameters differ")
    return out
