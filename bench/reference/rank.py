"""Predicted workload accuracy + orientation ranking (paper §3.1).

MadEye post-processes the approximation models' bounding boxes into
per-orientation *predicted workload accuracies*, computed relatively
against the other orientations explored this timestep:

  binary classification : 1 if any object of interest else 0
  counting              : count / max count among explored
  detection             : count + area term (mAP proxy) / max
  aggregate counting    : count score modulated to favor less-explored
                          orientations (unseen objects may hide there)

The workload prediction is the mean over its queries; global ranking
sorts explored orientations by that value.
"""
from __future__ import annotations

from dataclasses import dataclass

TASKS = ("binary", "count", "detect", "agg_count")


@dataclass(frozen=True)
class Query:
    model: str            # teacher model id (e.g. "yolov4", "ssd")
    obj: str              # "person" | "car"
    task: str             # one of TASKS

    def __post_init__(self):
        if self.task not in TASKS:
            raise ValueError(f"unknown task {self.task!r}; one of {TASKS}")


@dataclass(frozen=True)
class Workload:
    queries: tuple[Query, ...]

    @property
    def objects(self) -> set[str]:
        return {q.obj for q in self.queries}

    @property
    def models(self) -> set[str]:
        return {q.model for q in self.queries}


