"""ViT-S/16 [arXiv:2010.11929; paper tier].

Also the backbone class of MadEye's approximation-model detector
(configs/madeye_approx).
"""
from repro_torch.configs.base import VisionConfig, register

FULL = VisionConfig(
    name="vit-s16", img_res=224, patch=16, n_layers=12,
    d_model=384, n_heads=6, d_ff=1536,
)

SMOKE = VisionConfig(
    name="vit-s16-smoke", img_res=32, patch=8, n_layers=2,
    d_model=48, n_heads=3, d_ff=96, n_classes=10,
)

register(FULL, SMOKE)
