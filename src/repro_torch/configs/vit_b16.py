"""ViT-B/16 [arXiv:2010.11929; paper tier]."""
from repro_torch.configs.base import VisionConfig, register

FULL = VisionConfig(
    name="vit-b16", img_res=224, patch=16, n_layers=12,
    d_model=768, n_heads=12, d_ff=3072,
)

SMOKE = VisionConfig(
    name="vit-b16-smoke", img_res=32, patch=8, n_layers=2,
    d_model=64, n_heads=4, d_ff=128, n_classes=10,
)

register(FULL, SMOKE)
