"""Shared fixtures of the benchmark's CPU tests: a checkout-like root
holding a smoke-size cell of each configuration (the madeye-approx
smoke detector: 64 px crops, 2 layers of width 48; 3 cameras, 6 of 75
windows), with the committed metric readers and limits."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMOKE_SIZES = dict(img_res=64, patch=16, n_layers=2, d_model=48, n_heads=3,
                   d_ff=96, max_boxes=8, fpn_dim=32)
SMOKE_SEED = 2 ** 40 + 7


def write_root(root: Path, n_cameras: int = 3, shortlist_k: int = 6):
    """A root with BENCHMARK.json and bench/ files (the committed metric
    readers and model modules) for the smoke cells `smoke-approx` and
    `smoke-distill`."""
    bench = root / "bench"
    for d in ("metrics", "models"):
        shutil.copytree(ROOT / "bench" / d, bench / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for d in ("configs", "traffic", "limits"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    configs = []
    for name, src in (("smoke-approx", "madeye-approx"),
                      ("smoke-distill", "madeye-approx-distill")):
        c = json.loads((ROOT / f"bench/configs/{src}.json").read_text())
        c.update(SMOKE_SIZES, name=name)
        (bench / f"configs/{name}.json").write_text(json.dumps(c))
        configs.append({"name": name, "source": c["source"],
                        "file": f"bench/configs/{name}.json",
                        "reduced": list(SMOKE_SIZES), "why": "smoke"})
    t = json.loads((ROOT / "bench/traffic/f64-k18.json").read_text())
    t.update(n_cameras=n_cameras, shortlist_k=shortlist_k)
    (bench / "traffic/smoke.json").write_text(json.dumps(t))
    for cell, lim in (("smoke-approx", "approx-f64-k18"),
                      ("smoke-distill", "distill-f64-k18")):
        shutil.copy(ROOT / f"bench/limits/{lim}.json",
                    bench / f"limits/{cell}.json")
    real["configs"] = configs
    real["workloads"] = [
        {"name": n, "config": n, "traffic": "smoke", "chips": 1,
         "why": "smoke"} for n in ("smoke-approx", "smoke-distill")]
    for m in real["end_to_end"] + real["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(real, indent=1))
    return root


@pytest.fixture(scope="session")
def smoke_root(tmp_path_factory):
    return write_root(tmp_path_factory.mktemp("smoke_root"))


def run_smoke(root: Path, workload: str, *, seconds: float = 1.0,
              trace: bool = False, control: bool = False):
    """One run of a smoke cell on the CPU -> (result, stderr lines)."""
    import time

    import torch

    from bench.harness.cell import load_cell
    from bench.harness.runner import run_cell

    torch.set_num_threads(2)
    cell = load_cell(workload, root)
    return run_cell(cell, SMOKE_SEED, seconds, trace, "cpu",
                    time.perf_counter(), control=control)
