"""Teacher (workload) model profiles — biased oracles over the scene's
ground truth (paper §2.3 C2): per-model saturating detection ramps of
apparent size, plateau probabilities and deterministic per-(model,
class) quirks. Host-side constants; the device draws are
scene/observe.py's hashes."""
from __future__ import annotations

from dataclasses import dataclass


def _hash01(*keys) -> float:
    """Stable FNV-1a over the stringified keys (process-independent)."""
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


TEACHERS = {
    "frcnn": TeacherProfile("frcnn", 0.040, 0.12, 0.95, 0.010, 0.02),
    "yolov4": TeacherProfile("yolov4", 0.050, 0.15, 0.92, 0.015, 0.03),
    "ssd": TeacherProfile("ssd", 0.080, 0.20, 0.88, 0.020, 0.04),
    "tiny-yolov4": TeacherProfile("tiny-yolov4", 0.110, 0.28, 0.80, 0.030,
                                  0.06),
}
