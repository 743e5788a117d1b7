"""Teacher (workload) model zoo — biased oracles over simulator ground truth.

The paper's teachers are real CNNs (SSD, Faster-RCNN, YOLOv4, Tiny-YOLOv4
x {VOC, COCO}); offline we model each as a *deterministic biased oracle*:
a detector whose per-object detection probability is a saturating function
of apparent size with model-specific thresholds, plus localization noise
and false positives. This preserves exactly the properties MadEye's design
leans on (paper §2.3 C2):

  * different models discern different objects at the same orientation
    (different a_min / a_sat / p_max);
  * smaller objects are harder for everyone [80];
  * results flicker between consecutive frames [6, 76] (the per-frame
    hash component);
  * per-(model, class) biases diverge (hash-derived quirk factors).

Determinism: every random draw is a hash of (object id, model, frame
bucket), so the same video + workload always yields identical detections —
required for the relative-accuracy metrics to be reproducible.

`TEACHERS` is the port's one table of profiles: the host tables here and
the device oracle pass (scene/observe.teacher_arrays) both read it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _hash01(*keys) -> float:
    """Stable FNV-1a over the stringified keys (process-independent —
    Python's built-in hash() is salted per process and must not be used)."""
    h = 1469598103934665603
    for b in "|".join(map(str, keys)).encode():
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return (h & 0xFFFFFFFF) / 2 ** 32


@dataclass(frozen=True)
class TeacherProfile:
    name: str
    a_min: float          # apparent size floor (nothing below is seen)
    a_sat: float          # apparent size where detection prob saturates
    p_max: float          # plateau detection probability
    loc_sigma: float      # localization noise (fraction of box size)
    fp_rate: float        # false positives per (cell, frame)
    flicker: float = 0.4  # weight of the per-frame-bucket hash component

    def class_quirk(self, cls: int) -> float:
        """Deterministic per-(model, class) bias multiplier on a_min."""
        return 0.85 + 0.3 * _hash01(self.name, "quirk", int(cls))

    def detect_prob(self, apparent: np.ndarray, cls: int) -> np.ndarray:
        a0 = self.a_min * self.class_quirk(cls)
        a1 = self.a_sat * self.class_quirk(cls)
        x = np.clip((apparent - a0) / max(a1 - a0, 1e-6), 0.0, 1.0)
        return self.p_max * x


TEACHERS = {
    "frcnn": TeacherProfile("frcnn", 0.040, 0.12, 0.95, 0.010, 0.02),
    "yolov4": TeacherProfile("yolov4", 0.050, 0.15, 0.92, 0.015, 0.03),
    "ssd": TeacherProfile("ssd", 0.080, 0.20, 0.88, 0.020, 0.04),
    "tiny-yolov4": TeacherProfile("tiny-yolov4", 0.110, 0.28, 0.80, 0.030,
                                  0.06),
}


