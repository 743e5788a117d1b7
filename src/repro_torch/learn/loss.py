"""The distillation objective: pair buffer -> per-camera scalar loss.

Both payload modes reduce to `models/detector.detector_loss_from_outputs`
applied to the ring's static-shape teacher targets (boxes cxcywh,
classes, valid), weighted by the ring's slot-fill weights so empty
slots contribute nothing:

  * `distill_head_loss` — payload is staged post-neck features; only the
    camera's head convs run forward and backward (the paper's "final 3
    prediction layers");
  * `distill_full_loss` — payload is staged patch tokens; the camera's
    whole network (minus the shared patch embedding that produced the
    tokens) runs forward and backward.

Both take one camera's tensors; learn/loop.py maps them over the fleet
axis with `torch.func.vmap`, which keeps every camera's gradient its
own.
"""
from __future__ import annotations

import torch

from repro_torch.models.detector import (
    detector_loss_from_outputs,
    detector_loss_tokens,
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


def distill_full_loss(params, cfg, tokens: torch.Tensor,
                      boxes: torch.Tensor, classes: torch.Tensor,
                      valid: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Full-param objective for ONE camera's ring: staged patch tokens
    [B, P, D] re-run through the camera's trainable backbone and
    heads."""
    return detector_loss_tokens(params, cfg, tokens, boxes, classes, valid,
                                weight=weight)
