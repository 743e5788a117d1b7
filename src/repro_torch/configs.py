"""The MadEye approximation-model configs (paper §3.1: an
EfficientDet-D0-class detector, here a ViT-S-class backbone + FPN-lite
neck + anchor-free heads, ~4M params)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class DetectorConfig:
    """Light ViT backbone + anchor-free detection heads; float32."""
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 2               # {person, car}
    max_boxes: int = 32              # static box budget per frame
    fpn_dim: int = 128


MADEYE_APPROX = DetectorConfig(
    name="madeye-approx", img_res=224, patch=16, n_layers=6, d_model=192,
    n_heads=6, d_ff=768, n_classes=2, max_boxes=32, fpn_dim=128)

MADEYE_APPROX_SMOKE = DetectorConfig(
    name="madeye-approx-smoke", img_res=64, patch=16, n_layers=2,
    d_model=48, n_heads=3, d_ff=96, n_classes=2, max_boxes=8, fpn_dim=32)

_CONFIGS = {"madeye-approx": MADEYE_APPROX}
_SMOKE = {"madeye-approx": MADEYE_APPROX_SMOKE}


def get_config(name: str) -> DetectorConfig:
    """Full-width config by name."""
    return _CONFIGS[name]


def get_smoke_config(name: str) -> DetectorConfig:
    """Same family at smoke widths (what the CPU tests run)."""
    return _SMOKE[name]
