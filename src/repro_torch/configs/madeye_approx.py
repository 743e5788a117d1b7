"""The MadEye approximation-model configs (paper §3.1: an
EfficientDet-D0-class detector, here a ViT-S-class backbone + FPN-lite
neck + anchor-free heads, ~4M params)."""
from repro_torch.configs.base import DetectorConfig, register

MADEYE_APPROX = DetectorConfig(
    name="madeye-approx", img_res=224, patch=16, n_layers=6, d_model=192,
    n_heads=6, d_ff=768, n_classes=2, max_boxes=32, fpn_dim=128)

MADEYE_APPROX_SMOKE = DetectorConfig(
    name="madeye-approx-smoke", img_res=64, patch=16, n_layers=2,
    d_model=48, n_heads=3, d_ff=96, n_classes=2, max_boxes=8, fpn_dim=32)

register(MADEYE_APPROX, MADEYE_APPROX_SMOKE)
