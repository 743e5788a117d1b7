"""Per-family input-shape sets. The LM family's for now; the vision and
diffusion families' come with their models."""
from __future__ import annotations

from repro_torch.configs.base import ShapeSpec

LM_SHAPES = [
    ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
]

FAMILY_SHAPES = {
    "lm": LM_SHAPES,
}


def shapes_for(cfg) -> list[ShapeSpec]:
    return FAMILY_SHAPES[cfg.family]


def get_shape(cfg, shape_name: str) -> ShapeSpec:
    for s in shapes_for(cfg):
        if s.name == shape_name:
            return s
    raise KeyError(f"{shape_name} not a shape for family {cfg.family}")
