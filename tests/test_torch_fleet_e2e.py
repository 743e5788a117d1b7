"""The port as a whole: one FleetRunSpec JSON through both packages'
`run_fleet`, with the same JAX-written `.npz` detector weights, and the
port's no-fallback / no-JAX rules.

Decisions (`chosen` orientations, `frames_sent`) are equal; per-step
accuracy is held to 1e-6 (float32 means of equal grades).
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.fleet.api import FleetRunSpec as JSpec  # noqa: E402
from repro.fleet.api import run_fleet as j_run_fleet  # noqa: E402
from repro.fleet.runner import save_detector_params  # noqa: E402
from repro.models.detector import detector_init  # noqa: E402
from repro_torch.fleet.api import FleetResult  # noqa: E402
from repro_torch.fleet.api import FleetRunSpec as TSpec  # noqa: E402
from repro_torch.fleet.api import run_fleet as t_run_fleet  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    params = detector_init(jax.random.PRNGKey(1),
                           get_smoke_config("madeye-approx"))
    path = tmp_path_factory.mktemp("det") / "det.npz"
    return save_detector_params(str(path), params)


def _spec_json(weights_npz, shortlist_k):
    return JSpec(provider="detector", n_cameras=2, n_steps=4, seed=2,
                 shortlist_k=shortlist_k,
                 provider_kwargs={"det_params": weights_npz}).to_json()


@pytest.mark.parametrize("shortlist_k", [None, 18])
def test_detector_episode_matches_jax(weights_npz, shortlist_k):
    s = _spec_json(weights_npz, shortlist_k)
    want = j_run_fleet(JSpec.from_json(s))
    got = t_run_fleet(TSpec.from_json(s), device="cpu")
    assert got.chosen == want.chosen
    assert got.frames_sent == want.frames_sent
    np.testing.assert_allclose(got.acc_per_step, want.acc_per_step,
                               atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got.out.sent.numpy(),
                                  np.asarray(want.out.sent))
    np.testing.assert_array_equal(got.out.explored.numpy(),
                                  np.asarray(want.out.explored))
    assert got.n_steps == 4 and len(got.chosen[0]) == 2


def test_scene_episode_matches_jax():
    s = JSpec(provider="scene", n_cameras=2, n_steps=4, seed=5,
              budget={"fps": 4.0}).to_json()
    want = j_run_fleet(JSpec.from_json(s))
    got = t_run_fleet(TSpec.from_json(s), device="cpu")
    assert got.chosen == want.chosen
    assert got.frames_sent == want.frames_sent
    np.testing.assert_allclose(got.acc_per_step, want.acc_per_step,
                               atol=1e-6, rtol=0)


def test_spec_round_trips_through_port(weights_npz):
    s = _spec_json(weights_npz, 18)
    spec = TSpec.from_json(s)
    assert json.loads(spec.to_json()) == json.loads(s)
    assert TSpec.from_json(spec.to_json()) == spec


def test_result_json_round_trip():
    res = t_run_fleet(TSpec(provider="scene", n_cameras=1, n_steps=2),
                      device="cpu")
    back = FleetResult.from_json(res.to_json())
    assert back.chosen == res.chosen and back.spec == res.spec
    assert back.frames_sent == res.frames_sent


def test_unported_options_raise():
    """Sharding and the unfused detector path (fused=False) are not
    ported; metrics and distillation are (tests/test_torch_learn.py), the
    tables provider too (tests/test_torch_tables.py), and distillation on
    a provider without a per-window model is refused as in the
    reference."""
    for spec in (TSpec(shard={"kind": "debug"}),
                 TSpec(provider="detector", n_cameras=1, n_steps=1,
                       provider_kwargs={"fused": False})):
        with pytest.raises((NotImplementedError, KeyError)):
            t_run_fleet(spec, device="cpu")
    with pytest.raises(TypeError):
        t_run_fleet(TSpec(n_cameras=1, n_steps=1,
                          distill={"enabled": True}), device="cpu")
    res = t_run_fleet(TSpec(n_cameras=1, n_steps=2, metrics=True),
                      device="cpu")
    assert res.metrics["chosen_rank"].shape == (2, 1)


def test_run_fleet_never_falls_back_to_cpu():
    """Without a card, an entry point not told device='cpu' raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_run_fleet(TSpec(provider="detector", n_cameras=1, n_steps=1))


def test_port_imports_no_jax():
    """Importing every repro_torch module (and chip_smoke.py) leaves no
    jax or repro module loaded."""
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    mods = [m.removesuffix(".__init__") for m in mods]
    assert {"repro_torch.learn.loop", "repro_torch.learn.pairs",
            "repro_torch.learn.loss", "repro_torch.learn.spec",
            "repro_torch.train.optim", "repro_torch.obs.metrics"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'jaxlib', 'repro.')) or m == 'repro']\n"
        "print(len(sys.modules)); sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_do_not_import_jax():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for path in files:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_port_uses_no_torch_optim():
    """The learner's optimizers are written out (train/optim.py), as the
    reference's are: no module of the port reaches torch.optim."""
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr == "optim":
                assert not (isinstance(node.value, ast.Name)
                            and node.value.id == "torch"), path
            if isinstance(node, ast.ImportFrom):
                assert not (node.module or "").startswith("torch.optim"), path
            if isinstance(node, ast.Import):
                assert not any(a.name.startswith("torch.optim")
                               for a in node.names), path
