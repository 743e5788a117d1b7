"""On the card: one short run of each committed cell through the
benchmark's command, correct and well formed. Run on a CUDA machine with

    python -m pytest bench/tests -m requires_cuda
"""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ("approx-f64-k18", "distill-f64-k18", "approx-f256-k18")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workload, "--seed",
         "3000000019", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], out.stderr[-4000:]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["camera_steps_per_s"]["value"] > 0
