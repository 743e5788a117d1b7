"""The crop image model the approximation detector sees: class-colored
object rectangles painted in slot order (last painter wins) over a
textured gradient background plus per-camera render noise, the FOV
projection an axis-aligned crop in scene degrees. The fused
crop -> token stage is kernels/crop_patchify; this module holds the
pieces it shares (background, noise stream, paint colors).
"""
from __future__ import annotations

import torch

from repro_torch.scene import prng
from repro_torch.scene.scene import PERSON

_RENDER_SALT = 0x9E4DE
# (oid * 2654435761) % 97 without the 64-bit product: reduce both factors
# mod 97 first (2654435761 % 97 == 75), exact for any non-negative oid
_SHADE_MULT_97 = 2654435761 % 97

_PERSON_COLOR = (0.9, 0.3, 0.2)
_CAR_COLOR = (0.2, 0.4, 0.9)


def render_background(res: int, device=None) -> torch.Tensor:
    """[res, res, 3] textured gradient."""
    a = torch.arange(res, dtype=torch.float32, device=device) / res
    yy, xx = torch.meshgrid(a, a, indexing="ij")
    return torch.stack([0.35 + 0.15 * yy, 0.4 + 0.1 * xx,
                        0.35 + 0.05 * (xx + yy)], dim=-1)


def render_noise(rng: torch.Tensor, frame, res: int) -> torch.Tensor:
    """Per-camera standard-normal noise images [F, res, res, 3] for one
    frame. rng [F, 2] camera keys; the render stream is salted so it
    never collides with the scene-dynamics stream of the same keys."""
    keys = prng.fold_in(prng.fold_in(rng, _RENDER_SALT), frame)
    return prng.normal(keys, (res, res, 3))


def object_colors(kind: torch.Tensor, oid: torch.Tensor) -> torch.Tensor:
    """Per-object paint colors [..., M, 3]: class base color times the
    multiplicative oid shade, in modular arithmetic. kind [M], oid
    [..., M]."""
    shade = 0.7 + 0.3 * ((oid % 97) * _SHADE_MULT_97 % 97) / 97.0
    dev = oid.device
    person = torch.tensor(_PERSON_COLOR, device=dev)
    car = torch.tensor(_CAR_COLOR, device=dev)
    base = torch.where((kind == PERSON)[..., None], person, car)
    return base * shade[..., None]
