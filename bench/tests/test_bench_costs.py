"""The benchmark's operation and byte counts against hand arithmetic at
the committed cells' shapes, and pinned to the numbers the harness gave
before the model-specific counts moved into `bench/models/`."""
from __future__ import annotations

import json

import pytest

from bench.harness import costs
from bench.harness.cell import load_cell
from bench.harness.runner import dims
from conftest import ROOT

CELLS = ("approx-f64-k18", "distill-f64-k18", "approx-f256-k18")


def test_detector_flops_by_hand():
    cell = load_cell("approx-f64-k18", ROOT)
    model, s = cell.model, cell.sizes
    # 196 patches of 16 x 16 x 3 into 192; 197 tokens through 6 layers:
    # qkv 3 x 192 x 192, two 197 x 197 x 192 attention products, the
    # output projection, the 192 -> 768 -> 192 MLP; a 1x1 192 -> 128
    # and a 3x3 128 -> 128 neck; 3x3 heads of 2 + 4 + 1 outputs
    embed = 2 * 196 * 768 * 192
    layer = 2 * 197 * (192 * 576 + 2 * 197 * 192 + 192 * 192
                       + 2 * 192 * 768)
    neck = 2 * 196 * (192 * 128 + 9 * 128 * 128)
    heads = 2 * 196 * 9 * 128 * 7
    assert model.crop_flops(s) == embed + 6 * layer + neck + heads
    assert model.head_flops(s) == heads
    assert model.crop_flops(s) == pytest.approx(1.35299e9, rel=1e-5)


@pytest.mark.parametrize("workload", CELLS)
def test_step_flops_and_kernel_costs(workload):
    cell = load_cell(workload, ROOT)
    d = dims(cell)
    f = cell.traffic["n_cameras"]
    assert (d["shortlist_k"], d["n_objects"], d["n_pairs"],
            d["n_queries"], d["n_windows"]) == (18, 22, 4, 4, 75)
    per_crop = cell.model.crop_flops(cell.sizes)
    want = f * 18 * per_crop
    if cell.distill is not None:
        want += f * 8 * 2 * cell.model.head_flops(cell.sizes)
    assert costs.step_model_flops(d) == want
    # crop_patchify: 7 floats per object, 4 per window, a 224^2 RGB
    # plane a camera, the 768 x 192 weights and bias, 196 x 192 tokens a
    # crop; the 768-deep patch-embed product on every token
    n_bytes, n_ops = costs.crop_patchify_cost(d)
    assert n_bytes == 4 * (f * 22 * 7 + f * 18 * 4 + f * 224 * 224 * 3
                           + 768 * 192 + 192 + f * 18 * 196 * 192)
    assert n_ops == 2 * f * 18 * 196 * 768 * 192
    # oracle_pass: 25 bytes an object slot, 16 a camera, 32 a pair, 16
    # a window, 8 a query, 60 a (camera, window) of tables for 4 pairs
    n_bytes, n_ops = costs.oracle_pass_cost(d)
    assert n_bytes == f * 22 * 25 + 16 * f + 4 * 32 + 16 * 75 + 8 * 4 \
        + f * 75 * 60
    assert n_ops == f * 22 * 75 * (25 + 48) + f * 4 * 22 * 72
    # the least times: the patch embed is bound by its operations at the
    # TF32 rate, the oracle pass by its bytes
    assert costs.bound_s(*costs.crop_patchify_cost(d)) == pytest.approx(
        2 * f * 18 * 196 * 768 * 192 / 495e12)
    ob, oo = costs.oracle_pass_cost(d)
    assert costs.bound_s(ob, oo) == pytest.approx(ob / 3.35e12)


# step_model_flops, crop_patchify_cost and oracle_pass_cost as the
# harness computed them with the ViT's counts in bench/harness/costs.py
PINNED = {
    "approx-f64-k18": (1558644719616, (212591872, 66588770304.0),
                       (325584, 8114304)),
    "distill-f64-k18": (1561881673728, (212591872, 66588770304.0),
                        (325584, 8114304)),
    "approx-f256-k18": (6234578878464, (848595712, 266355081216.0),
                        (1298256, 32457216)),
}


@pytest.mark.parametrize("workload", CELLS)
def test_costs_pinned(workload):
    d = dims(load_cell(workload, ROOT))
    step, crop, oracle = PINNED[workload]
    assert costs.step_model_flops(d) == step
    assert costs.crop_patchify_cost(d) == crop
    assert costs.oracle_pass_cost(d) == oracle


def test_benchmark_json_shape():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in names
    for m in b["per_layer"]:
        assert m["moves"] in names
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
