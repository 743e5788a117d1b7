"""Float32 helpers shared across the package."""
from __future__ import annotations

import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor, c) -> torch.Tensor:
    """a*b + c in float32 with the product unrounded: the float32
    product is exact in float64, so only the sum rounds (to float64, then
    float32). Where a sum cancels (a variance from moments) this keeps
    the round-off of one fused multiply-add, which is also how the
    reference's compiled programs evaluate such expressions."""
    return (a.double() * b.double() + torch.as_tensor(c).double()).float()
