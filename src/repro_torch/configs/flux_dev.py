"""Flux-dev MMDiT rectified-flow [BFL tech report; unverified tier].

img_res=1024 latent_res=128 19 double blocks + 38 single blocks,
d_model=3072, 24 heads, ~12B params.
"""
from repro_torch.configs.base import DiffusionConfig, register

FULL = DiffusionConfig(
    name="flux-dev",
    img_res=1024,
    latent_res=128,
    patch=2,
    latent_channels=16,
    n_double_blocks=19,
    n_single_blocks=38,
    d_model=3072,
    n_heads=24,
    cond_dim=4096,
)

SMOKE = DiffusionConfig(
    name="flux-dev-smoke",
    img_res=32,
    latent_res=8,
    patch=2,
    latent_channels=4,
    n_double_blocks=2,
    n_single_blocks=2,
    d_model=64,
    n_heads=4,
    cond_dim=32,
)

register(FULL, SMOKE)
