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


def run_teacher(profile: TeacherProfile, gt_cell: dict, t: int, cls: int,
                *, flicker_bucket: int = 3) -> dict:
    """Run one teacher on one orientation view (exact GT in, biased out).

    Returns dict(ids [K], boxes [K,4], count, quality) — `quality` is the
    mean localization IoU proxy in [0,1] used by the mAP scoring.
    """
    mask = gt_cell["classes"] == cls
    apparent = gt_cell["apparent"][mask]
    ids = gt_cell["ids"][mask]
    boxes = gt_cell["boxes"][mask]

    p = profile.detect_prob(apparent, cls)
    bucket = t // flicker_bucket
    draws = np.array([
        (1 - profile.flicker) * _hash01(int(i), profile.name, "base")
        + profile.flicker * _hash01(int(i), profile.name, bucket)
        for i in ids]) if ids.size else np.zeros(0)
    det = draws < p

    out_ids = ids[det]
    out_boxes = boxes[det].copy()
    # localization noise (deterministic per id+bucket)
    if out_ids.size:
        jit = np.array([
            [_hash01(int(i), profile.name, bucket, ax) - 0.5
             for ax in range(4)] for i in out_ids])
        out_boxes[:, :2] += jit[:, :2] * profile.loc_sigma * 2
        out_boxes[:, 2:] *= 1.0 + jit[:, 2:] * profile.loc_sigma * 2
        quality = float(np.clip(
            1.0 - np.abs(jit).mean() * profile.loc_sigma * 20, 0.5, 1.0))
    else:
        quality = 1.0

    # false positives (hash-rate per cell-frame)
    n_fp = int(_hash01("fp", profile.name, t, int(gt_cell.get("cell", -1)))
               < profile.fp_rate)
    if n_fp:
        fx = _hash01("fpx", profile.name, t)
        fy = _hash01("fpy", profile.name, t)
        fp_box = np.array([[fx, fy, 0.05, 0.08]])
        out_boxes = np.concatenate([out_boxes, fp_box], axis=0)
        out_ids = np.concatenate([out_ids, [-1]])

    return {
        "ids": out_ids,
        "boxes": out_boxes,
        "count": int(out_ids.size),
        "quality": quality,
    }


def approx_observation(teacher_out: dict, *, miss_rate: float = 0.12,
                       seed_key=(0,)) -> dict:
    """Degrade a teacher output into what the *approximation model* would
    produce — the student mimics the teacher but with extra misses (its
    3.9M params can't match the teacher everywhere). Deterministic."""
    ids = teacher_out["ids"]
    keep = np.array([
        _hash01("approx", int(i), *seed_key) >= miss_rate for i in ids],
        bool) if ids.size else np.zeros(0, bool)
    return {
        "ids": ids[keep],
        "boxes": teacher_out["boxes"][keep],
        "count": int(keep.sum()),
        "quality": teacher_out["quality"] * 0.95,
    }
