"""Per-family input-shape sets (the JAX package's cells)."""
from __future__ import annotations

from repro_torch.configs.base import ShapeSpec

LM_SHAPES = [
    ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
]

DIFFUSION_SHAPES = [
    ShapeSpec("train_256", "train", img_res=256, global_batch=256, steps=1000),
    ShapeSpec("gen_1024", "generate", img_res=1024, global_batch=4, steps=50),
    ShapeSpec("gen_fast", "generate", img_res=512, global_batch=16, steps=4),
    ShapeSpec("train_1024", "train", img_res=1024, global_batch=32,
              steps=1000),
]

VISION_SHAPES = [
    ShapeSpec("cls_224", "train", img_res=224, global_batch=256),
    ShapeSpec("cls_384", "train", img_res=384, global_batch=64),
    ShapeSpec("serve_b1", "serve", img_res=224, global_batch=1),
    ShapeSpec("serve_b128", "serve", img_res=224, global_batch=128),
]

FAMILY_SHAPES = {
    "lm": LM_SHAPES,
    "diffusion": DIFFUSION_SHAPES,
    "vision": VISION_SHAPES,
}


def shapes_for(cfg) -> list[ShapeSpec]:
    return FAMILY_SHAPES[cfg.family]


def get_shape(cfg, shape_name: str) -> ShapeSpec:
    for s in shapes_for(cfg):
        if s.name == shape_name:
            return s
    raise KeyError(f"{shape_name} not a shape for family {cfg.family}")
