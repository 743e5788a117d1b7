"""The lower-precision control fails: the reference with TF32-rounded
products in the program's place reads past the committed limits, at
smoke size on the CPU (TF32 rounding emulated in the reference)."""
from __future__ import annotations

import json

import pytest

from conftest import ROOT, run_smoke


@pytest.mark.parametrize("workload,cell", [
    ("smoke-approx", "approx-f64-k18"),
    ("smoke-distill", "distill-f64-k18")])
def test_tf32_control_fails(smoke_root, workload, cell):
    res, lines = run_smoke(smoke_root, workload, seconds=0.5,
                           control=True)
    assert res["correct"], lines
    limits = json.loads(
        (ROOT / f"bench/limits/{cell}.json").read_text())["limits"]
    nums = res["numbers"]
    failed = [k for k in limits if f"control_{k}" in nums
              and nums[f"control_{k}"] > limits[k]]
    assert failed, nums
    assert nums["control_detector"] > limits["detector"]
