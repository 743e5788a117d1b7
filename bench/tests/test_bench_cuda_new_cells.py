"""On the card: one short run of each cell added with the Swin-B
detector (`swinb-f32-k18`) and the 200-cell grid (`approx-f64-g200-m40`)
through the benchmark's command, correct and well formed, with at least
one whole step in the window. Run on a CUDA machine with

    python -m pytest bench/tests -m requires_cuda
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ("swinb-f32-k18", "approx-f64-g200-m40")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS)
def test_new_cell_runs_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workload, "--seed",
         "3000000023", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], out.stderr[-4000:]
    assert res["device"]["platform"] == "gpu" and res["attempted"] >= 1
    assert res["metrics"]["camera_steps_per_s"]["value"] > 0
