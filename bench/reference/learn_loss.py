"""The head-only distillation objective: pair buffer -> per-camera
scalar loss. The payload is staged post-neck features; only the
camera's head convs run forward and backward (the paper's "final 3
prediction layers"), through `detector.detector_loss_from_outputs` on
the ring's static-shape teacher targets (boxes cxcywh, classes, valid),
weighted by the ring's slot-fill weights so empty slots contribute
nothing. It takes one camera's tensors; learn_loop maps it over the
fleet axis with `torch.func.vmap`, which keeps every camera's gradient
its own.
"""
from __future__ import annotations

import torch

from bench.reference.detector import (
    detector_loss_from_outputs,
    head_outputs,
)


def distill_head_loss(heads, feats: torch.Tensor, boxes: torch.Tensor,
                      classes: torch.Tensor, valid: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Head-only objective for ONE camera's ring: heads the camera's
    head params, feats [B, g, g, Fd] staged post-neck features,
    boxes/classes/valid the teacher targets [B, mb, ...], weight [B]
    slot-fill weights. Returns a scalar."""
    return detector_loss_from_outputs(*head_outputs(heads, feats), boxes,
                                      classes, valid, weight=weight)

