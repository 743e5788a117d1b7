"""Knowledge-distillation label generation (paper §3.1-3.2), in numpy.

Approximation models are trained to mimic *the registered query's model*,
not ground truth — the whole point is to capture that teacher's biases
(what it can discern, at which scales, under which orientations). The
teacher's detections on a frame become the student's training targets.

`teacher_labels` converts any teacher output into the static-shape target
tensors `detector_loss` consumes. `distill_batch` packages a replay-buffer
sample into one training batch.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class DistillTargets(NamedTuple):
    boxes: np.ndarray     # [B, N, 4] cxcywh in [0,1]
    classes: np.ndarray   # [B, N] int32
    valid: np.ndarray     # [B, N] bool


def teacher_labels(teacher_boxes: list, teacher_classes: list,
                   max_boxes: int) -> DistillTargets:
    """Per-image variable-length teacher detections -> static targets.

    teacher_boxes: list (len B) of [k_i, 4] arrays; teacher_classes:
    list of [k_i] arrays. Extra boxes beyond max_boxes are dropped by
    descending area (small boxes are least informative for ranking).
    """
    B = len(teacher_boxes)
    boxes = np.zeros((B, max_boxes, 4), np.float32)
    classes = np.zeros((B, max_boxes), np.int32)
    valid = np.zeros((B, max_boxes), bool)
    for i, (bb, cc) in enumerate(zip(teacher_boxes, teacher_classes)):
        bb = np.asarray(bb, np.float32).reshape(-1, 4)
        cc = np.asarray(cc, np.int32).reshape(-1)
        if bb.shape[0] > max_boxes:
            order = np.argsort(-(bb[:, 2] * bb[:, 3]))[:max_boxes]
            bb, cc = bb[order], cc[order]
        k = bb.shape[0]
        boxes[i, :k] = bb
        classes[i, :k] = cc
        valid[i, :k] = True
    return DistillTargets(boxes, classes, valid)


def rank_agreement(pred_scores: np.ndarray, true_scores: np.ndarray) -> float:
    """Training-accuracy proxy the tradeoff balancer consumes: how often
    does the student rank the best orientation in the top slot?

    Both arrays [K] over the same explored orientations."""
    if pred_scores.size == 0:
        return 1.0
    return float(np.argmax(pred_scores) == np.argmax(true_scores))


def spearman(pred_scores: np.ndarray, true_scores: np.ndarray) -> float:
    """Rank-correlation metric for the Fig-16 style microbenchmark."""
    if pred_scores.size < 2:
        return 1.0
    pr = np.argsort(np.argsort(-pred_scores))
    tr = np.argsort(np.argsort(-true_scores))
    n = pred_scores.size
    return float(1 - 6 * np.sum((pr - tr) ** 2) / (n * (n ** 2 - 1)))
