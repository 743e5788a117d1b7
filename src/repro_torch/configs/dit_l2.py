"""DiT-L/2 [arXiv:2212.09748; paper tier].

img_res=256 (latent 32), patch=2, 24 layers, d_model=1024, 16 heads.
"""
from repro_torch.configs.base import DiffusionConfig, register

FULL = DiffusionConfig(
    name="dit-l2",
    img_res=256,
    patch=2,
    latent_channels=4,
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_classes=1000,
)

SMOKE = DiffusionConfig(
    name="dit-l2-smoke",
    img_res=32,
    patch=2,
    latent_channels=4,
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_classes=10,
)

register(FULL, SMOKE)
