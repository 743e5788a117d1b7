"""Seeded numpy weights and inputs for the vision and diffusion half of
the model zoo. Weights in the reference's layout: the port's init drawn
by numpy (the same under any PyTorch), float32, with every leaf a
trained model would have moved off its init perturbed (zero-initialised
adaLN linears and final projections get LeCun-scale draws, biases small
draws, norm scales 1 + small draws), so every parameter is exercised.
Imports numpy and the port only, so the card-only tests run it where
JAX is not installed."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import diffusion, dit, mmdit, swin, vit
from repro_torch.scene import prng

VISION_ARCHS = ["vit-s16", "vit-b16", "vit-h14", "swin-b"]
DIFFUSION_ARCHS = ["dit-l2", "flux-dev"]


def smoke(arch: str, dtype: torch.dtype, **changes):
    return dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               **changes)


def port_init(cfg, gen, device="cpu"):
    """The port's init for cfg's family."""
    if cfg.family == "vision":
        if cfg.swin:
            return swin.swin_init(gen, cfg, device=device)
        return vit.vit_init(gen, cfg, device=device)
    if cfg.is_mmdit:
        return mmdit.mmdit_init(gen, cfg, device=device)
    return dit.dit_init(gen, cfg, device=device)


def perturb_numpy(tree, rng):
    """A tree of tensors -> float32 numpy arrays, each leaf a trained
    model would have moved off its init drawn from `rng`: all-zero
    matrices (adaLN-zero, final projections) at LeCun scale, all-zero
    vectors (biases) at 0.05, all-one vectors (norm scales) at 1 +
    N(0, 0.1); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: perturb_numpy(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [perturb_numpy(v, rng) for v in tree]
    a = tree.float().numpy()
    if np.all(a == 0) and a.ndim >= 2:           # adaLN-zero, final_proj
        a = rng.normal(0, 1 / np.sqrt(a.shape[-2]), a.shape)
    elif np.all(a == 0):                          # biases
        a = rng.normal(0, 0.05, a.shape)
    elif np.all(a == 1):                          # norm scales
        a = 1 + rng.normal(0, 0.1, a.shape)
    return a.astype(np.float32)


def numpy_weights(cfg, seed: int = 0):
    """cfg's parameters as a float32 numpy tree in the reference's
    layout (dicts, stacked layers, Swin's per-stage block lists)."""
    fresh = port_init(dataclasses.replace(cfg, dtype=torch.float32),
                      np.random.default_rng(seed))
    return perturb_numpy(fresh, np.random.default_rng(seed + 1000))


def smoke_outputs(cfg, params, dev, *, vit_impl: str = "xla") -> tuple:
    """cfg's outputs on `dev` on numpy-drawn inputs (batch 2): the
    forward (the ViTs with `vit_impl`) and the loss; for the diffusion
    models also the sampler at 2 steps."""
    rng = np.random.default_rng(7)

    def arr(x):
        return torch.as_tensor(x).to(dev)

    if cfg.family == "vision":
        img = arr(rng.uniform(0, 1, (2, cfg.img_res, cfg.img_res, 3))
                  .astype(np.float32))
        lab = arr(rng.integers(0, cfg.n_classes, 2))
        if cfg.swin:
            return (swin.swin_forward(params, cfg, img),
                    swin.swin_loss(params, cfg, img, lab))
        return (vit.vit_forward(params, cfg, img, impl=vit_impl),
                vit.vit_loss(params, cfg, img, lab))
    r = cfg.latent_res or cfg.img_res // 8
    lat = arr(rng.normal(0, 1, (2, r, r, cfg.latent_channels))
              .astype(np.float32))
    key = prng.PRNGKey(3, device=dev)
    if cfg.is_mmdit:
        txt = arr(rng.normal(0, 1, (2, 8, cfg.cond_dim)).astype(np.float32))
        t = arr(np.array([0.1, 0.8], np.float32))
        return (mmdit.mmdit_forward(params, cfg, lat, t, txt),
                diffusion.rf_train_loss(params, cfg, lat, txt, key),
                diffusion.rf_sample(params, cfg, key, batch=2, n_steps=2,
                                    txt_emb=txt))
    t = arr(np.array([5.0, 900.0], np.float32))
    y = arr(np.array([1, cfg.n_classes]))
    return (dit.dit_forward(params, cfg, lat, t, y),
            diffusion.dit_train_loss(params, cfg, lat, y, key),
            diffusion.dit_sample(params, cfg, key, batch=2, n_steps=2))
