"""Workload queries (paper §3.1). The predicted-accuracy ranking the
controller computes is fleet/step._rank."""
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
