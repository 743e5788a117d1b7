"""A cell found by name: its entry in BENCHMARK.json, its configuration
file, its traffic mix (`traffic/<name>.json`) and the limits of its
comparison (`limits/<workload>.json`)."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# the detector's sizes, as a configuration file names them
DETECTOR_KEYS = ("img_res", "patch", "n_layers", "d_model", "n_heads",
                 "d_ff", "n_classes", "max_boxes", "fpn_dim")


@dataclass(frozen=True)
class DetectorSizes:
    """The detector's sizes and score threshold (attribute access, as
    both the program's DetectorConfig and the reference read them)."""
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int
    max_boxes: int
    fpn_dim: int
    score_thresh: float


@dataclass(frozen=True)
class Cell:
    root: Path              # the checkout the cell's files were read from
    workload: str
    chips: int
    config: dict            # the configuration file
    traffic: dict           # the traffic file
    limits: dict            # the comparison's limits
    end_to_end: tuple       # BENCHMARK.json metric entries of this cell
    per_layer: tuple

    @property
    def sizes(self) -> DetectorSizes:
        c = self.config
        return DetectorSizes(name=c["name"], score_thresh=c["score_thresh"],
                             **{k: c[k] for k in DETECTOR_KEYS})

    @property
    def distill(self) -> dict | None:
        return self.config.get("distill")


def _reported(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"cells: {', '.join(sorted(cells))}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads(
        (root / "bench" / "limits" / f"{workload}.json").read_text())
    return Cell(
        root=root, workload=workload, chips=w["chips"], config=config,
        traffic=traffic, limits=limits,
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if _reported(m, workload)),
        per_layer=tuple(m for m in bench["per_layer"]
                        if _reported(m, workload)))
