"""A cell found by name: its entry in BENCHMARK.json, its configuration
file, the model module that configuration names (`models/<model>.py`),
its traffic mix (`traffic/<name>.json`) and the limits of its comparison
(`limits/<workload>.json`)."""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[2]


@dataclass(frozen=True)
class Cell:
    root: Path              # the checkout the cell's files were read from
    workload: str
    chips: int
    config: dict            # the configuration file
    model: ModuleType       # bench/models/<config's model>.py
    traffic: dict           # the traffic file
    limits: dict            # the comparison's limits
    end_to_end: tuple       # BENCHMARK.json metric entries of this cell
    per_layer: tuple

    @property
    def sizes(self):
        """The model's sizes object, from the configuration file."""
        return self.model.sizes(self.config)

    @property
    def distill(self) -> dict | None:
        return self.config.get("distill")


def _reported(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def load_file(path: Path, kind: str) -> ModuleType:
    """The Python file `path` loaded as a module of its own (a metric
    reader, a model), found by its file and not by import. It is
    registered under `bench_<kind>_<stem>` while it runs and after, as
    an import would be (dataclasses look their module up there)."""
    stem = path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_model(root: Path, name: str) -> ModuleType:
    """The model module `bench/models/<name>.py` under `root`."""
    path = root / "bench" / "models" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"model {name!r} has no module: {path} does not exist")
    return load_file(path, "model")


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"cells: {', '.join(sorted(cells))}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    file = configs[w["config"]]["file"]
    config = json.loads((root / file).read_text())
    if "model" not in config:
        raise ValueError(f"{file} names no model: it needs a \"model\" key, "
                         f"the name of a module under bench/models/")
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads(
        (root / "bench" / "limits" / f"{workload}.json").read_text())
    return Cell(
        root=root, workload=workload, chips=w["chips"], config=config,
        model=load_model(root, config["model"]), traffic=traffic,
        limits=limits,
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if _reported(m, workload)),
        per_layer=tuple(m for m in bench["per_layer"]
                        if _reported(m, workload)))
