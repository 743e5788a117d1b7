"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (the port's `repro_torch` begins with `repro`);
the reference loads nothing of the port."""
from __future__ import annotations

import subprocess
import sys

from conftest import ROOT

PROBE = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
{body}
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(' '.join(tops))
"""


def _tops(body: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(
            root=str(ROOT), src=str(ROOT / "src"), body=body)],
        capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_forbidden_names_are_whole():
    sys.path.insert(0, str(ROOT / "bench"))
    try:
        import run
    finally:
        sys.path.remove(str(ROOT / "bench"))
    assert run.forbidden_modules(["repro_torch", "repro_torch.fleet.api",
                                  "torch", "reproduce"]) == []
    assert run.forbidden_modules(["repro.fleet.api", "jaxlib.xla_client",
                                  "flax", "jax"]) == ["flax", "jax",
                                                      "jaxlib", "repro"]


def test_reference_loads_nothing_of_the_port():
    tops = _tops("import bench.reference.episode\n"
                 "import bench.harness.check")
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_model_reference_side_loads_nothing_of_the_port():
    # the ViT's module loaded, and its reference run once on one camera's
    # three shortlisted windows at the committed sizes
    tops = _tops(f"""
import json
from pathlib import Path
import torch
from bench.harness.cell import load_model
from bench.harness.weights import make_weights
from bench.reference import episode as ref
root = Path({str(ROOT)!r})
m = load_model(root, "vit_detector")
s = m.sizes(json.loads((root / "bench/configs/madeye-approx.json")
                       .read_text()))
t = json.loads((root / "bench/traffic/f64-k18.json").read_text())
t.update(n_cameras=1, shortlist_k=3)
w = ref.build_world(m, s, t, 5, "cpu", None)
acc = ref.oracle(w, w.state0, w.scene0)
with torch.no_grad():
    ref.detect(w, make_weights(m.leaves(s), 5, "cpu"), w.state0, w.scene0,
               acc)
m.crop_flops(s), m.patch_embed(s)
""")
    assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_harness_loads_no_jax():
    tops = _tops("import bench.harness.runner\n"
                 "import repro_torch.fleet.api\n"
                 "import repro_torch.fleet.runner")
    assert "repro_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
