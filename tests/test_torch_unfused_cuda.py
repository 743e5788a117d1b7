"""This slice's paths on the card against the same calls on the CPU
(`requires_cuda`: skipped without a card). Imports no JAX, so it runs
where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_unfused_cuda.py

Tolerances: crops within 6e-8 (one ulp; the same owners); decisions
(`explored`, `order`, `zooms`, `sent`, `chosen`) exact; the unfused
episode decides as the fused exhaustive one on the card; the
materialized tables episode decides as its scene episode; the host
fine-tune's loss within 1e-4 relative of the CPU's (float32
convolutions in other orders), its backbone bit-unchanged.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import DEFAULT_GRID  # noqa: E402
from repro_torch.core import continual  # noqa: E402
from repro_torch.core.distill import teacher_labels  # noqa: E402
from repro_torch.core.tradeoff import BudgetConfig  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    FleetRunSpec,
    fleet_config,
    fleet_statics,
    make_scene_provider,
    materialize_scene_tables,
    run_fleet,
    run_fleet_episode,
    workload_spec,
)
from repro_torch.models import detector as det  # noqa: E402
from repro_torch.scene.render import render_fleet_crops  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.train.optim import tree_leaves  # noqa: E402

DECISIONS = ("explored", "order", "zooms", "sent", "chosen")
CFG = get_smoke_config("madeye-approx")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


def _same(a, b):
    for k in DECISIONS:
        np.testing.assert_array_equal(getattr(a, k).cpu().numpy(),
                                      getattr(b, k).cpu().numpy(),
                                      err_msg=k)


@pytest.mark.requires_cuda
def test_render_fleet_crops_card_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(0)
    pos = torch.rand((3, 22, 2), generator=gen) * torch.tensor([150., 75.])
    size = 1.5 + 7.5 * torch.rand((3, 22, 2), generator=gen)
    kind = (torch.arange(22) >= 14).long()
    oid = torch.randint(0, 4000, (3, 22), generator=gen)
    from repro_torch.scene.observe import grid_windows
    wins = grid_windows(DEFAULT_GRID)[:15]
    noise = 0.05 * torch.randn((3, 64, 64, 3), generator=gen)
    cpu = render_fleet_crops(pos, size, kind, oid, wins, noise=noise)
    card = render_fleet_crops(*(x.to(cuda) for x in (pos, size, kind, oid,
                                                      wins)),
                              noise=noise.to(cuda))
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), atol=6e-8,
                               rtol=0)


@pytest.mark.requires_cuda
def test_unfused_episode_card_matches_cpu_and_fused(cuda):
    spec = FleetRunSpec(provider="detector", n_cameras=2, n_steps=3,
                        seed=1, provider_kwargs={"fused": False,
                                                 "scene_seeds": [5, 9]})
    on_card, on_cpu = run_fleet(spec), run_fleet(spec, device="cpu")
    _same(on_card.out, on_cpu.out)
    fused = run_fleet(dataclasses.replace(spec, provider_kwargs={
        "scene_seeds": [5, 9]}))
    _same(on_card.out, fused.out)


@pytest.mark.requires_cuda
def test_materialized_tables_replay_on_card(cuda):
    grid = DEFAULT_GRID
    cfg = fleet_config(grid, BudgetConfig(fps=2.0))
    wl = workload_spec(FleetRunSpec().workload_obj())
    provider, st = make_scene_provider(
        grid, FleetRunSpec().workload_obj(), cfg, n_cameras=3, n_steps=14,
        scene_seeds=[7, 7, 7], device=cuda)
    statics = fleet_statics(grid, cuda)
    tables = materialize_scene_tables(cfg, wl, statics, st, provider)
    assert tables.counts.device.type == "cuda"
    with torch.no_grad():
        _, scene, _, _ = run_fleet_episode(cfg, wl, statics, st, provider)
        _, replay, _, _ = run_fleet_episode(cfg, wl, statics, st, tables)
    _same(scene, replay)


@pytest.mark.requires_cuda
def test_detector_controller_on_card_matches_run_fleet(cuda):
    kw = dict(n_cameras=2, n_steps=3, seed=0, scene_seeds=[5, 9],
              shortlist_k=9)
    _, out = engine.run_fleet_detector_controller(
        DEFAULT_GRID, FleetRunSpec().workload_obj(), BudgetConfig(), **kw)
    res = run_fleet(FleetRunSpec(provider="detector", n_cameras=2,
                                 n_steps=3, shortlist_k=9,
                                 provider_kwargs={"scene_seeds": [5, 9]}))
    assert out.chosen.device.type == "cuda"
    _same(out, res.out)


@pytest.mark.requires_cuda
def test_finetune_step_card_matches_cpu(cuda):
    params = det.detector_init(torch.Generator().manual_seed(0), CFG)
    rng = np.random.default_rng(0)
    imgs = rng.normal(0.5, 0.2, (8, 64, 64, 3)).astype(np.float32)
    tgt = teacher_labels([np.array([[0.3, 0.4, 0.2, 0.3]])] * 8,
                         [np.array([i % 2]) for i in range(8)],
                         CFG.max_boxes)
    losses = {}
    for dev in ("cpu", cuda):
        p = det.params_from_numpy(params, dev)
        backbone = [x.clone() for x in tree_leaves(p["backbone"])]
        opt = continual.init_finetune(p)
        args = [torch.as_tensor(x, device=dev) for x in (imgs, *tgt)]
        losses[str(dev)] = []
        for _ in range(3):
            p, opt, loss = continual.finetune_step(p, opt, CFG, *args,
                                                   lr=3e-3)
            losses[str(dev)].append(float(loss))
        assert all(torch.equal(a, b) for a, b in zip(
            backbone, tree_leaves(p["backbone"])))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
