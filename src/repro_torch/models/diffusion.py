"""Diffusion training losses and samplers: DDPM (epsilon prediction,
DDIM sampling at eta 0) for DiT, rectified flow (velocity prediction,
Euler sampling) for the MMDiT.

Each sampler step is one backbone forward. Keys are the port's
threefry keys (scene/prng.py: `PRNGKey(seed)`): the same key draws the
same timesteps and noise as `jax.random` does in the reference (normal
draws within prng.normal's known ulps). The schedules and timesteps are
computed in float32 as the reference's `jnp.linspace` computes them, so
the integer timesteps are the reference's (for up to 352 steps).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import DiffusionConfig
from repro_torch.models.dit import dit_forward
from repro_torch.models.layers import params_from_numpy
from repro_torch.models.mmdit import TXT_TOKENS, mmdit_forward
from repro_torch.scene import prng


def diffusion_params_from_numpy(tree, dtype, device=None):
    """The reference's DiT or MMDiT parameters (as `dit_init` /
    `mmdit_init` in the JAX package make them, numpy or JAX arrays) ->
    the port's tree on `device` (the card unless the caller passes
    "cpu"), floating leaves in `dtype`; stacked layers keep the
    reference's layout."""
    return params_from_numpy(tree, dtype, device)


def linspace_f32(start: float, stop: float, num: int,
                 device=None) -> torch.Tensor:
    """`jnp.linspace(start, stop, num)` in float32 as XLA compiles it on
    the CPU: step = i * (1 / div) (its division by a constant becomes
    a product by the float32 reciprocal), start * (1 - step) + stop *
    step, the last entry stop. Bit-equal for num <= 352; past that
    XLA's vector loop contracts 1 - i * (1 / div) into a fused
    multiply-add, which moves some entries by an ulp."""
    return torch.as_tensor(_linspace_f32_np(start, stop, num),
                           device=device)


def _linspace_f32_np(start: float, stop: float, num: int) -> np.ndarray:
    """linspace_f32's values on the host, each op rounded to float32."""
    f32 = np.float32
    lo, hi = f32(start), f32(stop)
    if num == 1:
        return np.array([lo], f32)
    div = num - 1
    step = np.arange(div, dtype=f32) * (f32(1.0) / f32(div))
    return np.concatenate([lo * (f32(1) - step) + hi * step, [hi]]
                          ).astype(f32)


def ddpm_schedule(n_steps: int = 1000, beta_0: float = 1e-4,
                  beta_T: float = 0.02, device=None) -> dict:
    """Linear betas, alphas = 1 - betas and their cumulative products,
    float32 [n_steps] each."""
    betas = linspace_f32(beta_0, beta_T, n_steps, device)
    alphas = 1.0 - betas
    return {"betas": betas, "alphas": alphas,
            "alpha_bars": torch.cumprod(alphas, 0)}


def ddim_timesteps(n_steps: int, train_steps: int = 1000) -> list[int]:
    """The sampler's integer timesteps, train_steps - 1 down to 0:
    `jnp.linspace(train_steps - 1, 0, n_steps).astype(int32)` (float32
    values truncated)."""
    return [int(v) for v in _linspace_f32_np(train_steps - 1, 0, n_steps)]


def _device(params) -> torch.device:
    return params["final_proj"]["w"].device


def dit_train_loss(params, cfg: DiffusionConfig, latents: torch.Tensor,
                   y: torch.Tensor, key: torch.Tensor, *,
                   n_steps: int = 1000) -> torch.Tensor:
    """Epsilon-prediction MSE. latents [B, R, R, C] clean; y [B]
    labels; key a prng key (the timesteps and the noise are drawn from
    its two halves)."""
    b = latents.shape[0]
    dev = latents.device
    sched = ddpm_schedule(n_steps, device=dev)
    kt, ke = prng.split(key.to(dev), 2)
    t = prng.randint(kt, (b,), 0, n_steps)
    eps = prng.normal(ke, tuple(latents.shape))
    ab = sched["alpha_bars"][t][:, None, None, None]
    x_t = torch.sqrt(ab) * latents.float() + torch.sqrt(1 - ab) * eps
    pred = dit_forward(params, cfg, x_t.to(cfg.dtype), t.float(), y).float()
    return torch.mean(torch.square(pred - eps))


def dit_sample(params, cfg: DiffusionConfig, key: torch.Tensor, *,
               batch: int, n_steps: int = 50, train_steps: int = 1000,
               y: torch.Tensor | None = None,
               latent_res: int | None = None) -> torch.Tensor:
    """DDIM sampler (eta = 0): n_steps forwards on the parameters'
    device. Returns float32 latents [B, R, R, C]."""
    dev = _device(params)
    r = latent_res or cfg.latent_res or cfg.img_res // 8
    c = cfg.latent_channels
    abar = ddpm_schedule(train_steps, device=dev)["alpha_bars"]
    if y is None:
        y = torch.zeros(batch, dtype=torch.long, device=dev)
    ts = ddim_timesteps(n_steps, train_steps)
    x = prng.normal(key.to(dev), (batch, r, r, c))
    one = torch.ones((), device=dev)
    for i, t in enumerate(ts):
        last = i + 1 >= n_steps
        ab_t = abar[t]
        ab_p = one if last else abar[ts[i + 1]]
        eps = dit_forward(params, cfg, x.to(cfg.dtype),
                          torch.full((batch,), float(t), device=dev),
                          y).float()
        x0 = (x - torch.sqrt(1 - ab_t) * eps) / torch.sqrt(ab_t)
        x = torch.sqrt(ab_p) * x0 + torch.sqrt(1 - ab_p) * eps
    return x


def rf_train_loss(params, cfg: DiffusionConfig, latents: torch.Tensor,
                  txt_emb: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Rectified-flow MSE on the velocity. latents [B, R, R, C] clean;
    timesteps logit-normal (SD3 / Flux practice)."""
    b = latents.shape[0]
    dev = latents.device
    kt, ke = prng.split(key.to(dev), 2)
    t = torch.sigmoid(prng.normal(kt, (b,)))
    noise = prng.normal(ke, tuple(latents.shape))
    x1 = latents.float()
    tb = t[:, None, None, None]
    x_t = (1 - tb) * noise + tb * x1
    pred = mmdit_forward(params, cfg, x_t.to(cfg.dtype), t,
                         txt_emb).float()
    return torch.mean(torch.square(pred - (x1 - noise)))


def rf_sample(params, cfg: DiffusionConfig, key: torch.Tensor, *,
              batch: int, n_steps: int = 50,
              txt_emb: torch.Tensor | None = None,
              latent_res: int | None = None) -> torch.Tensor:
    """Euler integration of the learned velocity field from t = 0
    (noise): n_steps forwards on the parameters' device. Returns float32
    latents [B, R, R, C]."""
    dev = _device(params)
    r = latent_res or cfg.latent_res or cfg.img_res // 8
    c = cfg.latent_channels
    if txt_emb is None:
        txt_emb = torch.zeros(batch, TXT_TOKENS, cfg.cond_dim, device=dev)
    x = prng.normal(key.to(dev), (batch, r, r, c))
    dt = torch.tensor(1.0 / n_steps, dtype=torch.float32, device=dev)
    for i in range(n_steps):
        t = torch.full((batch,), float(i), device=dev) * dt
        v = mmdit_forward(params, cfg, x.to(cfg.dtype), t, txt_emb).float()
        x = x + dt * v
    return x
