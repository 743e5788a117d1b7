"""The Swin detector (`bench/models/swin_detector.py`, its reference
`bench/reference/swin_detector.py`) at a smoke size on the CPU: 64 px
crops at patch 4, stages of 2 / 2 / 2 blocks at widths 32 / 64 / 128 in
windows of 4, so the first two stages shift their windows under the
region mask, two merges join the stages, the last stage's 4 x 4 map is
no larger than its window (no shift), and the neck upsamples it onto
the second stage's 8 x 8 map.

The port against the reference on the same seeded weights and tokens;
a smoke cell through `load_cell` and `run_cell`, frozen and distilling,
correct; the port with its shift mask dropped or its relative-bias
index transposed, not correct; the counts at Swin-B's widths; the
backbone's span readers on a synthetic trace.
"""
from __future__ import annotations

import json
import shutil

import pytest
import torch

from bench.harness.cell import load_cell, load_model
from bench.harness.runner import read_metric
from bench.harness.weights import make_weights
from conftest import ROOT, SMOKE_SEED, run_smoke, write_root
from test_bench_imports import _tops

SWIN_SMOKE = dict(img_res=64, patch=4, window=4, depths=[2, 2, 2],
                  dims=[32, 64, 128], heads=[1, 2, 4], max_boxes=8,
                  fpn_dim=32)
MS = 1_000_000


def swin_config(name: str, distill: bool = False) -> dict:
    c = json.loads((ROOT / "bench/configs/madeye-swin-b.json").read_text())
    c.update(SWIN_SMOKE, name=name)
    if distill:
        c["distill"] = json.loads((ROOT / "bench/configs/"
                                   "madeye-approx-distill.json")
                                  .read_text())["distill"]
    return c


def add_swin_cells(root):
    """Smoke cells `smoke-swin` and `smoke-swin-distill` on the smoke
    traffic, with the committed cells' limits."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, distill, lim in (("smoke-swin", False, "swinb-f32-k18"),
                               ("smoke-swin-distill", True,
                                "distill-f64-k18")):
        (root / f"bench/configs/{name}.json").write_text(
            json.dumps(swin_config(name, distill)))
        shutil.copy(ROOT / f"bench/limits/{lim}.json",
                    root / f"bench/limits/{name}.json")
        bench["configs"].append({"name": name,
                                 "source": "https://arxiv.org/abs/2103.14030",
                                 "file": f"bench/configs/{name}.json",
                                 "reduced": list(SWIN_SMOKE),
                                 "why": "smoke"})
        bench["workloads"].append({"name": name, "config": name,
                                   "traffic": "smoke", "chips": 1,
                                   "why": "smoke"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def swin_root(tmp_path_factory):
    return add_swin_cells(write_root(tmp_path_factory.mktemp("swin_root")))


def _model_and_sizes():
    model = load_model(ROOT, "swin_detector")
    return model, model.sizes(swin_config("smoke-swin"))


def _port_cfg(model, s):
    return model.program(s)[1]["det_cfg"]


def test_port_matches_reference():
    """Post-neck features and detections of the port's Swin detector
    (models/detector.py) against the plain reference, on seeded weights
    and tokens. Both are float32 on the CPU; their products and sums
    run in other orders and groupings (the port's batched windows and
    einsum attention, the reference's per-window matmuls), so values
    of order 1 agree to a few float32 ulps, far inside 1e-5."""
    from repro_torch.models import detector as det

    model, s = _model_and_sizes()
    w = make_weights(model.leaves(s), SMOKE_SEED, "cpu")
    g = torch.Generator().manual_seed(5)
    tokens = torch.rand((6, (s.img_res // s.patch) ** 2, s.dims[0]),
                        generator=g) * 2 - 1
    cfg = _port_cfg(model, s)
    from bench.reference import swin_detector as ref
    with torch.no_grad():
        port = det.params_from_numpy(w)      # as prepare_fleet_run reads it
        feats = det.detector_neck_feats_tokens(port, cfg, tokens)
        want = ref.swin_neck_feats_tokens(w, s, tokens)
        assert feats.shape == (6,) + model.neck_shape(s)
        torch.testing.assert_close(feats, want, rtol=0, atol=1e-5)
        got = det.detector_forward_tokens(port, cfg, tokens)
        dets = ref.swin_detector_forward_tokens(w, s, tokens)
    for a, b in zip(got, dets):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    assert float(got.scores.max()) > 0


def test_leaves_are_the_ports_tree():
    """The harness's leaves spell the tree the port's detector_init
    draws: the same paths and shapes."""
    from repro_torch.models.detector import detector_init

    model, s = _model_and_sizes()

    def flat(tree, pre=""):
        out = {}
        items = (tree.items() if isinstance(tree, dict)
                 else enumerate(tree))               # Swin's stage lists
        for k, v in items:
            p = f"{pre}/{k}" if pre else str(k)
            out.update(flat(v, p) if isinstance(v, (dict, list))
                       else {p: tuple(v.shape)})
        return out

    port = flat(detector_init(torch.Generator().manual_seed(0),
                              _port_cfg(model, s), "cpu"))
    assert port == {k: sh for k, (sh, _) in model.leaves(s).items()}


@pytest.mark.parametrize("workload", ["smoke-swin", "smoke-swin-distill"])
def test_smoke_cell_correct(swin_root, workload):
    res, lines = run_smoke(swin_root, workload, seconds=0.5)
    assert res["correct"], lines
    assert res["failed"] == 0 and res["attempted"] >= 1
    if workload == "smoke-swin-distill":
        assert {"learn_loss", "learn_update"} <= set(res["checks"])


def _no_mask(real):
    return lambda h, w, window, shift, device: torch.zeros_like(
        real(h, w, window, shift, device))


def _transposed(real):
    return lambda window, device: real(window, device).t().contiguous()


@pytest.mark.parametrize("target,fault", [("shift_mask", _no_mask),
                                          ("rel_index", _transposed)],
                         ids=["shift_mask_dropped", "rel_index_transposed"])
def test_fault_is_caught(swin_root, monkeypatch, target, fault):
    from repro_torch.models import swin

    monkeypatch.setattr(swin, target, fault(getattr(swin, target)))
    res, lines = run_smoke(swin_root, "smoke-swin", seconds=0.5)
    assert not res["correct"], lines
    assert res["failed"] > 0
    assert res["checks"]["detector"]["value"] > \
        res["checks"]["detector"]["limit"]


def test_swin_b_counts():
    """Crop FLOPs at Swin-B's widths by hand: per block 24 t d^2 for the
    projections and the 4x MLP plus 4 t 49 d for scores and values;
    merges 16 t' d^2 at their t' output tokens; the patch embed; a 1x1
    512 -> 128 and 1024 -> 128 lateral, a 3x3 smooth, the heads."""
    cell = load_cell("swinb-f32-k18", ROOT)
    model, s = cell.model, cell.sizes
    stages = [(2, 3136, 128), (2, 784, 256), (18, 196, 512), (2, 49, 1024)]
    blocks = sum(n * (24 * t * d * d + 4 * t * 49 * d)
                 for n, t, d in stages)
    merges = sum(16 * (t // 4) * d * d for _, t, d in stages[:3])
    embed = 2 * 3136 * 48 * 128
    heads = 2 * 196 * 9 * 128 * 7
    neck = 2 * 196 * 512 * 128 + 2 * 49 * 1024 * 128 + 2 * 196 * 9 * 128 ** 2
    assert model.head_flops(s) == heads
    assert model.crop_flops(s) == blocks + merges + embed + neck + heads
    assert model.crop_flops(s) == pytest.approx(30.96e9, rel=1e-3)
    assert model.neck_shape(s) == (14, 14, 128)
    assert model.patch_embed(s) == (4, 224, 128)
    assert (s.depths, s.dims, s.window) == ((2, 2, 18, 2),
                                            (128, 256, 512, 1024), 7)
    assert cell.traffic["n_cameras"] * cell.traffic["shortlist_k"] == 576


def test_reference_loads_nothing_of_the_port():
    tops = _tops(f"""
import json
from pathlib import Path
import torch
from bench.harness.cell import load_model
from bench.harness.weights import make_weights
from bench.reference import episode as ref
root = Path({str(ROOT)!r})
m = load_model(root, "swin_detector")
c = json.loads((root / "bench/configs/madeye-swin-b.json").read_text())
c.update({SWIN_SMOKE!r})
s = m.sizes(c)
t = json.loads((root / "bench/traffic/f32-k18.json").read_text())
t.update(n_cameras=1, shortlist_k=3)
w = ref.build_world(m, s, t, 5, "cpu", None)
acc = ref.oracle(w, w.state0, w.scene0)
with torch.no_grad():
    ref.detect(w, make_weights(m.leaves(s), 5, "cpu"), w.state0, w.scene0,
               acc)
m.crop_flops(s), m.patch_embed(s)
""")
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def _trace(backbone: bool = True):
    """Two 100 ms steps, each with a `madeye/backbone` span at 50-70 ms
    inside `madeye/detect` (50-80 ms); kernels at 10-30, 55-62 and
    64-75 ms: the device idles 50-55 and 62-64 ms of the span."""
    host, dev = [], []
    for s in (0, 100):
        host += [("madeye/step", s * MS, (s + 100) * MS),
                 ("madeye/detect", (s + 50) * MS, (s + 80) * MS)]
        if backbone:
            host.append(("madeye/backbone", (s + 50) * MS, (s + 70) * MS))
        dev += [("k", (s + a) * MS, (s + b) * MS)
                for a, b in ((10, 30), (55, 62), (64, 75))]
    # a backbone span outside every step is not counted
    host.append(("madeye/backbone", 300 * MS, 310 * MS))
    return {"host": host, "device": dev, "steps": 2}


@pytest.mark.parametrize("tr,want", [
    (_trace(), (20.0, 7.0)), (_trace(backbone=False), (None, None)),
    ({"host": _trace()["host"], "device": [], "steps": 2}, (None, None))],
    ids=["spans", "no_backbone_span", "no_device_events"])
def test_backbone_readers(tr, want):
    ctx = {"trace": tr}
    got = tuple(read_metric(ROOT, m, ctx)
                for m in ("backbone_host_ms", "backbone_idle_ms"))
    assert got == (pytest.approx(want[0]) if want[0] else None,
                   pytest.approx(want[1]) if want[1] else None)


def test_backbone_entries():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ("backbone_host_ms", "backbone_idle_ms"):
        m = per_layer[name]
        assert (m["source"], m["moves"], m["layer"], m["workloads"]) == (
            "device_trace", "camera_steps_per_s", "detector backbone",
            ["swinb-f32-k18"])
