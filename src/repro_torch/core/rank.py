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

import numpy as np

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


def query_scores(task: str, counts: np.ndarray, areas: np.ndarray,
                 visits: np.ndarray) -> np.ndarray:
    """Per-orientation predicted accuracy for one query.

    counts [K] — #objects-of-interest the approx model saw per explored
    orientation; areas [K] — summed box areas (mAP proxy); visits [K] —
    historical visit counts (aggregate-counting novelty bonus).
    """
    counts = counts.astype(np.float64)
    if task == "binary":
        return (counts > 0).astype(np.float64)
    if task == "count":
        m = counts.max()
        return counts / m if m > 0 else np.zeros_like(counts)
    if task == "detect":
        # count + area proxy: finding the same count with larger boxes is
        # worth more mAP (better localization odds)
        m = counts.max()
        cscore = counts / m if m > 0 else np.zeros_like(counts)
        am = areas.max()
        ascore = areas / am if am > 0 else np.zeros_like(areas)
        return 0.7 * cscore + 0.3 * ascore
    if task == "agg_count":
        m = counts.max()
        base = counts / m if m > 0 else np.zeros_like(counts)
        novelty = 1.0 / np.sqrt(1.0 + visits)
        s = base * (1.0 + novelty)
        sm = s.max()
        return s / sm if sm > 0 else s
    raise ValueError(task)


def predict_workload_accuracy(workload: Workload,
                              per_query_counts: dict,
                              per_query_areas: dict,
                              visits: np.ndarray) -> np.ndarray:
    """per_query_counts[(model, obj)] -> counts [K] from that query's
    approximation model. Returns predicted workload accuracy [K]."""
    total = None
    for q in workload.queries:
        key = (q.model, q.obj)
        s = query_scores(q.task, per_query_counts[key],
                         per_query_areas[key], visits)
        total = s if total is None else total + s
    return total / len(workload.queries)


def rank_orientations(pred_acc: np.ndarray) -> np.ndarray:
    """Descending rank order (indices into the explored set)."""
    return np.argsort(-pred_acc, kind="stable")
