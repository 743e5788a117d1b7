"""Cells are found by name from their own files: the committed ones
resolve, and a new configuration, traffic mix, limits file and metric
reader are picked up without an edit to any existing file."""
from __future__ import annotations

import json
import re
import shutil

from bench.harness.cell import load_cell
from conftest import ROOT, run_smoke, write_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_committed_cells_resolve():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    metrics = bench["end_to_end"] + bench["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"])
        assert (ROOT / "bench/metrics" / f"{m['name']}.py").exists()
    for w in bench["workloads"]:
        cell = load_cell(w["name"], ROOT)
        assert cell.traffic["n_cameras"] > 0
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert cell.per_layer
        assert cell.limits["limits"]
    for c in bench["configs"]:
        assert (ROOT / c["file"]).exists()


def test_new_cell_found_without_edits(tmp_path):
    root = write_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    t = json.loads((root / "bench/traffic/smoke.json").read_text())
    t.update(n_cameras=2, shortlist_k=3)
    (root / "bench/traffic/smoke-f2-k3.json").write_text(json.dumps(t))
    shutil.copy(root / "bench/configs/smoke-approx.json",
                root / "bench/configs/smoke-other.json")
    shutil.copy(root / "bench/limits/smoke-approx.json",
                root / "bench/limits/smoke-other.f2.json")
    (root / "bench/metrics/steps_done.py").write_text(
        "def read(ctx):\n    return ctx['window'].steps\n")
    bench["configs"].append(dict(bench["configs"][0], name="smoke-other",
                                 file="bench/configs/smoke-other.json"))
    bench["workloads"].append(
        {"name": "smoke-other.f2", "config": "smoke-other",
         "traffic": "smoke-f2-k3", "chips": 1, "why": "a later cell"})
    bench["end_to_end"].append(
        {"name": "steps_done", "unit": "steps", "better": "higher",
         "bound": 0.01, "source": "host_clock",
         "workloads": ["smoke-other.f2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res, lines = run_smoke(root, "smoke-other.f2", seconds=0.5)
    assert res["correct"], lines
    assert res["metrics"]["steps_done"]["value"] == res["attempted"]
    assert set(res["metrics"]) >= {"camera_steps_per_s", "setup_s"}
    other, _ = run_smoke(root, "smoke-approx", seconds=0.3)
    assert "steps_done" not in other["metrics"]
