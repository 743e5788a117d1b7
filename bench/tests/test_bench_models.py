"""A configuration names its model, and the harness finds the model's
module (`bench/models/<model>.py`) under the cell's own root: a model
written into a new root alone runs through `load_cell` and `run_cell`,
its counts and weights are the ones read, and the committed ViT's
weights from a seed are those the harness drew before the model moved
into its module."""
from __future__ import annotations

import hashlib
import json
import shutil
import time

import pytest
import torch

from bench.harness.cell import load_cell
from bench.harness.program import Window
from bench.harness.runner import dims, read_metric, run_cell
from bench.harness.weights import make_weights
from conftest import ROOT, SMOKE_SEED, write_root

# the ViT detector, its crop FLOPs counted twice and its objectness
# weights drawn at twice the std; `drawn` records each call of `leaves`
DOUBLE = '''
from pathlib import Path

from bench.harness.cell import load_model

base = load_model(Path(__file__).resolve().parents[2], "vit_detector")
sizes, program, head_flops = base.sizes, base.program, base.head_flops
patch_embed, neck_shape = base.patch_embed, base.neck_shape
reference_detect = base.reference_detect
drawn = []


def leaves(s):
    drawn.append(s)
    out = base.leaves(s)
    shape, std = out["heads/obj/w"]
    out["heads/obj/w"] = (shape, 2 * std)
    return out


def crop_flops(s):
    return 2 * base.crop_flops(s)
'''

# sha256 of the smoke weights at SMOKE_SEED on the CPU, as the harness
# drew them with the ViT's leaves in bench/harness/weights.py
SMOKE_DIGEST = ("a56628ea4b81ce06e5e84037a859cdfb"
                "83a3f479ea08f41d120862092beae63f")


def _files(d) -> dict:
    return {str(p.relative_to(d)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in d.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _add_cell(root, name: str, config: dict):
    """Configuration `name` (`config` over smoke-approx's) and its cell
    on the smoke traffic, limits as smoke-approx's."""
    c = json.loads((root / "bench/configs/smoke-approx.json").read_text())
    c.update(config, name=name)
    (root / f"bench/configs/{name}.json").write_text(json.dumps(c))
    shutil.copy(root / "bench/limits/smoke-approx.json",
                root / f"bench/limits/{name}.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name=name,
                                 file=f"bench/configs/{name}.json"))
    bench["workloads"].append({"name": name, "config": name,
                               "traffic": "smoke", "chips": 1,
                               "why": "a later model"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def _digest(tree: dict) -> str:
    flat = {}

    def walk(node, pre):
        for k, v in node.items():
            p = f"{pre}/{k}" if pre else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                flat[p] = v

    walk(tree, "")
    h = hashlib.sha256()
    for p in sorted(flat):
        x = flat[p].contiguous()
        h.update(f"{p}:{tuple(x.shape)}:{x.dtype};".encode())
        h.update(x.numpy().tobytes())
    return h.hexdigest()


def test_new_model_from_new_files_alone(tmp_path):
    before = _files(ROOT / "bench")
    root = write_root(tmp_path)
    (root / "bench/models/vit_double.py").write_text(DOUBLE)
    _add_cell(root, "smoke-double", {"model": "vit_double"})

    cell = load_cell("smoke-double", root)
    torch.set_num_threads(2)
    res, lines = run_cell(cell, SMOKE_SEED, 0.5, False, "cpu",
                          time.perf_counter())
    assert res["correct"], lines
    # the run's weights and the comparison's came from the fixture
    assert cell.model.drawn == [cell.sizes, cell.sizes]
    vit = load_cell("smoke-approx", root)
    w2 = make_weights(cell.model.leaves(cell.sizes), SMOKE_SEED, "cpu")
    w1 = make_weights(vit.model.leaves(vit.sizes), SMOKE_SEED, "cpu")
    assert torch.equal(w2["heads"]["obj"]["w"], 2 * w1["heads"]["obj"]["w"])
    assert torch.equal(w2["heads"]["cls"]["w"], w1["heads"]["cls"]["w"])
    # step_mfu at one step time: twice the ViT cell's share
    mfu = [read_metric(root, "step_mfu", {
        "busy_s": 1.0, "window": Window(steps=10, seconds=2.0),
        "dims": dims(c)}) for c in (cell, vit)]
    assert mfu[0] == pytest.approx(2 * mfu[1], rel=1e-12)
    assert _files(ROOT / "bench") == before


@pytest.mark.parametrize("config,error,names", [
    ({"model": None}, ValueError, '"model" key'),
    ({"model": "nowhere"}, FileNotFoundError, "bench/models/nowhere.py")],
    ids=["no_model_key", "no_model_file"])
def test_missing_model_is_an_error(tmp_path, config, error, names):
    root = write_root(tmp_path)
    _add_cell(root, "smoke-missing", config)
    if config["model"] is None:
        path = root / "bench/configs/smoke-missing.json"
        c = json.loads(path.read_text())
        del c["model"]
        path.write_text(json.dumps(c))
    with pytest.raises(error, match=names):
        load_cell("smoke-missing", root)


@pytest.mark.parametrize("workload", ["smoke-approx", "smoke-distill"])
def test_weights_pinned(smoke_root, workload):
    cell = load_cell(workload, smoke_root)
    tree = make_weights(cell.model.leaves(cell.sizes), SMOKE_SEED, "cpu")
    assert _digest(tree) == SMOKE_DIGEST
