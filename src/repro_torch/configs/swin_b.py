"""Swin-B [arXiv:2103.14030; paper tier].

img_res=224 patch=4 window=7 depths=(2,2,18,2) dims=(128,256,512,1024).
"""
from repro_torch.configs.base import VisionConfig, register

FULL = VisionConfig(
    name="swin-b", img_res=224, patch=4, n_layers=24,
    d_model=128, n_heads=4, d_ff=512, swin=True, window=7,
    depths=(2, 2, 18, 2), dims=(128, 256, 512, 1024),
)

SMOKE = VisionConfig(
    name="swin-b-smoke", img_res=32, patch=4, n_layers=4,
    d_model=16, n_heads=2, d_ff=64, swin=True, window=2,
    depths=(1, 1), dims=(16, 32), n_classes=10,
)

register(FULL, SMOKE)
