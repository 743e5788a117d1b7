"""The detector's other paths and the host entry points on the card
(`requires_cuda`: skipped without a card). Imports no JAX, so it runs
where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_unfused_cuda.py

Against the same calls on the CPU: crops within 6e-8 (one ulp; the same
owners); decisions (`explored`, `order`, `zooms`, `sent`, `chosen`)
exact; the unfused episode decides as the fused exhaustive one on the
card; the materialized tables episode decides as its scene episode; the
host fine-tune's loss within 1e-4 relative of the CPU's (float32
convolutions in other orders), its backbone bit-unchanged; `serve
--fleet 4` prints the same accuracies (its tables path launching the
search kernels once a step, nothing else but threefry's draws); the
tables recording and replay launch the oracle pass and the search
kernels once a step each. At madeye-approx's full width: the serving
shim `run_fleet_detector_controller` launches the main path's kernels
once a step and decides as run_fleet; `InferenceEngine` counts as on
the CPU, areas within 1e-4, but near a decision boundary; and the
anchor, the unfused reference against the fused path on every window
(see test_anchor_unfused_against_fused_at_full_width). The three
`python -m repro_torch.examples.*` run on the card.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
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
from repro_torch.fleet import runner as runner_module  # noqa: E402
from repro_torch.fleet.api import prepare_fleet_run  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.launch import serve as serve_module  # noqa: E402
from repro_torch.models import detector as det  # noqa: E402
from repro_torch.scene.render import render_fleet_crops  # noqa: E402
from repro_torch.serving import engine  # noqa: E402
from repro_torch.train.optim import tree_leaves  # noqa: E402
from repro_torch.models.layers import full_float32  # noqa: E402
from repro_torch.scene.observe import grid_windows  # noqa: E402
from repro_torch.scene.render import render_noise  # noqa: E402
from repro_torch.scene.scene import (  # noqa: E402
    SceneSpec,
    advance_scene,
    init_scene,
    kind_mask,
    scene_fleet_params,
)
from torch_kernel_inputs import (  # noqa: E402
    clone_tree,
    count_card_draws,
    vit_dense_launches,
)

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
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    tables = materialize_scene_tables(cfg, wl, statics, st, provider)
    assert tables.counts.device.type == "cuda"
    with torch.no_grad():
        _, scene, _, _ = run_fleet_episode(cfg, wl, statics, st, provider)
        _, replay, _, _ = run_fleet_episode(cfg, wl, statics, st, tables)
    torch.cuda.synchronize()
    _same(scene, replay)
    # the oracle pass in the recording and the scene episode, the search
    # kernels in all three
    assert {k: v for k, v in _lib.launch_counts().items()
            if v and k != "threefry"} == {
        "oracle_pass": 2 * 14, "shape_search": 3 * 14, "budget_walk": 3 * 14}


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
def test_detector_controller_at_full_width(cuda, monkeypatch):
    """run_fleet_detector_controller at madeye-approx's full width (8
    cameras, 3 steps, shortlist 18; no warm-up step) launches the
    search kernels, the oracle pass and crop_patchify once a step, dense
    once for each large enough linear of the step's forward (8 x 18
    crops: the MLP's, not attention's d x d), flash_attention once for
    each of the ViT's layers, threefry once for each draw on the card,
    and nothing else; and decides as run_fleet on the same spec."""
    cfg = get_config("madeye-approx")
    n_cam, n_steps, k = 8, 3, 18
    draws = count_card_draws(monkeypatch)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    _, out = engine.run_fleet_detector_controller(
        DEFAULT_GRID, FleetRunSpec().workload_obj(), BudgetConfig(),
        n_cameras=n_cam, n_steps=n_steps, det_cfg=cfg, shortlist_k=k)
    torch.cuda.synchronize()
    counts = {name: v for name, v in _lib.launch_counts().items() if v}
    assert counts.pop("threefry") == draws[0]
    assert counts == {name: n_steps for name in SEARCH_AND_ORACLE} | {
        "crop_patchify": n_steps,
        "dense": n_steps * vit_dense_launches(cfg, n_cam * k),
        "flash_attention": n_steps * cfg.n_layers}
    res = run_fleet(FleetRunSpec(provider="detector", n_cameras=n_cam,
                                 n_steps=n_steps, shortlist_k=k,
                                 provider_kwargs={"det_cfg": cfg}))
    _same(out, res.out)


def _full_width_images(n: int, seed: int) -> torch.Tensor:
    """n cameras' crops of one window each (the grid's windows in turn)
    at madeye-approx's 224 px, with render noise, from seeded scenes
    advanced a few frames (CPU)."""
    spec = SceneSpec()
    res = get_config("madeye-approx").img_res
    params, rng = scene_fleet_params(spec, n, seed=seed)
    sc = advance_scene(spec, params, rng, init_scene(spec, params, rng), 2,
                       4)
    wins = grid_windows(DEFAULT_GRID)
    crops = render_fleet_crops(
        sc.pos, sc.size, torch.as_tensor(kind_mask(spec)), sc.oid,
        wins[torch.arange(n) % wins.shape[0]][:, None], res=res,
        noise=0.05 * render_noise(rng, 2, res))
    return crops[:, 0]


@pytest.mark.requires_cuda
def test_inference_engine_at_full_width_card_matches_cpu(cuda):
    """InferenceEngine.counts_and_areas at madeye-approx's full width on
    64 images, weights numpy draws from ANCHOR_SEED, at ENGINE_THRESH:
    the card's counts equal the CPU's and its areas are within 1e-4 of
    them, but on images holding a detection within NEAR_BAND of a
    decision boundary (the threshold, the top-k cut, a class tie)."""
    cfg = get_config("madeye-approx")
    params = det.detector_init(np.random.default_rng(ANCHOR_SEED), cfg)
    images = _full_width_images(64, seed=4)
    on_card = engine.InferenceEngine(cfg, params, cuda).counts_and_areas(
        images, score_thresh=ENGINE_THRESH)
    on_cpu = engine.InferenceEngine(cfg, params, "cpu").counts_and_areas(
        images, score_thresh=ENGINE_THRESH)
    assert on_card[0].device.type == "cuda" and int(on_cpu[0].sum()) > 0
    with torch.no_grad(), full_float32():
        cls_logits, _, obj_logits = det.detector_raw(
            det.params_from_numpy(params, "cpu"), cfg, images)
    near_t, near_other = near_boundary(*raw_scores(cls_logits, obj_logits),
                                       (ENGINE_THRESH,), cfg.max_boxes)
    differ = ((on_card[0].cpu() != on_cpu[0])
              | ((on_card[1].cpu() - on_cpu[1]).abs() > 1e-4))
    assert not bool((differ & ~(near_t | near_other)).any()), (
        torch.nonzero(differ & ~(near_t | near_other)).flatten().tolist())


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


@pytest.mark.requires_cuda
def test_serve_tables_card_matches_cpu(cuda, monkeypatch, capsys):
    """`serve --fleet 4` (the tables provider) on the card and on the
    CPU: the same eight printed accuracies and the same decisions."""
    results, run = [], serve_module.run_fleet

    def kept(*args, **kwargs):
        results.append(run(*args, **kwargs))
        return results[-1]

    monkeypatch.setattr(serve_module, "run_fleet", kept)
    accs = {}
    for dev in ("cuda", "cpu"):
        _lib.reset_launch_counts()
        serve_module.serve(fps=2.0, duration=3.0, fleet=4, device=dev)
        accs[dev] = {k.strip(): v for k, v in re.findall(
            r"^(.+?)\s*:\s*acc=([0-9.]+)", capsys.readouterr().out, re.M)}
        if dev == "cuda":         # the search kernels once a step and the
            steps = len(results[0].chosen) + 1          # warm-up step
            assert {k: v for k, v in _lib.launch_counts().items()
                    if v and k != "threefry"} == {"shape_search": steps,
                                                  "budget_walk": steps}
    assert accs["cuda"] == accs["cpu"] and len(accs["cuda"]) == 8
    _same(*(r.out for r in results))


# the examples' small REPRO_EX_* overrides and their result lines
EXAMPLES = [
    ("fleet_experiment", {"REPRO_EX_CAMERAS": "8", "REPRO_EX_STEPS": "3"},
     "fleet accuracy"),
    ("adaptive_serving", {"REPRO_EX_DURATION": "2.0",
                          "REPRO_EX_STEPS": "3"},
     "NN-in-the-loop MadEye accuracy"),
    ("continual_distillation", {"REPRO_EX_DURATION": "2.0",
                                "REPRO_EX_EVALS": "4"},
     "replay: rank quality"),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name,overrides,marker", EXAMPLES,
                         ids=[e[0] for e in EXAMPLES])
def test_example_runs_on_card(cuda, name, overrides, marker):
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, **overrides)
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, (str(root / "src"), env.get("PYTHONPATH"))))
    proc = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}"], env=env,
        cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert marker in proc.stdout


# a detection within this of a decision boundary (a score threshold, the
# top-k cut, a class tie) may fall on either side under float32 round-off
# in another order; windows near a threshold, and windows that differ
# between the two formulations (each must hold a detection near a
# boundary), may each be at most NEAR_SHARE of all
NEAR_BAND, NEAR_SHARE = 1e-4, 1e-3
# the anchor's weights: drawn by numpy, so the card runs the same net
# under any PyTorch, at the threshold of fresh weights
ANCHOR_SEED, FRESH_THRESH = 0, 0.3
# the serving engine's threshold on those weights: counts of 0 to 6 of
# the 32 boxes an image (at FRESH_THRESH every box counts)
ENGINE_THRESH = 0.5
SEARCH_AND_ORACLE = ("shape_search", "budget_walk", "oracle_pass")


def raw_scores(cls_logits, obj_logits):
    """Raw head outputs -> (every cell's score [B, g*g], the margin
    between its two most probable classes [B, g*g]), as the decode
    computes them before its top-k."""
    b = cls_logits.shape[0]
    probs = torch.softmax(
        cls_logits.reshape(b, -1, cls_logits.shape[-1]).float(), dim=-1)
    score = torch.sigmoid(obj_logits.reshape(b, -1).float()) * probs.amax(-1)
    top2 = probs.topk(2, dim=-1).values
    return score, top2[..., 0] - top2[..., 1]


def near_boundary(score, margin, thresholds, k: int):
    """Rows [B] whose detections (the top-k cells) sit within NEAR_BAND
    of a decision boundary -> (a detection's score near one of
    `thresholds`; the k-th and (k+1)-th scores near each other or a
    detection's two classes near a tie)."""
    ranked = score.sort(dim=-1, descending=True).values
    kept = score >= ranked[:, k - 1:k]
    near_t = torch.zeros(score.shape[0], dtype=torch.bool)
    for t in thresholds:
        near_t |= (((score - t).abs() < NEAR_BAND) & kept).any(-1)
    near_other = ((margin < NEAR_BAND) & kept).any(-1)
    if ranked.shape[1] > k:
        near_other |= ranked[:, k - 1] - ranked[:, k] < NEAR_BAND
    return near_t, near_other


def _anchor_run(monkeypatch, spec, steps, n_cam, c):
    """run_fleet(spec) with its launches (threefry's, once for each draw
    on the card, left out), and each step's tables and raw scores on the
    [F, C] window axis (the first recorded step, the warm-up, left
    out)."""
    obs, raw = [], []
    with monkeypatch.context() as mp:
        draws = count_card_draws(mp)
        for module, name, keep in (
                (runner_module, "detections_obs",
                 lambda a, out: obs.append(clone_tree(out))),
                (det, "_decode_detections",
                 lambda a, out: raw.append(tuple(
                     x.cpu() for x in raw_scores(a[1], a[3]))))):
            def kept(*args, _fn=getattr(module, name), _keep=keep,
                     **kwargs):
                out = _fn(*args, **kwargs)
                _keep(args, out)
                return out
            mp.setattr(module, name, kept)
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        result = run_fleet(spec)
        torch.cuda.synchronize()
    counts = {k: v for k, v in _lib.launch_counts().items() if v}
    assert counts.pop("threefry") == draws[0]
    # the unfused path decodes slab by slab (window = slab * chunk + j)
    per_step = len(raw) // steps
    scores = [tuple(torch.stack(
        [x[i].reshape(n_cam, -1, x[i].shape[-1])
         for x in raw[e * per_step:(e + 1) * per_step]], 1)
        .reshape(n_cam, c, -1) for i in range(2)) for e in range(steps)]
    return result, counts, obs[1:], scores[1:]


@pytest.mark.requires_cuda
def test_anchor_unfused_against_fused_at_full_width(cuda, monkeypatch):
    """The unfused reference (fused=False: every window rendered to
    pixels and scored, 15 a slab) against the fused path at shortlist_k
    = 75 (every window through crop_patchify), madeye-approx at full
    width, 64 cameras, 8 steps, on weights numpy draws from a seed:
    each run launches the search kernels and the oracle pass once a
    step, the fused one crop_patchify too, the unfused one never, dense
    once for each large enough linear of each detector forward (the
    unfused one a forward a slab), flash_attention once for each ViT
    layer of each forward, threefry once a draw, nothing else; every
    cell's raw score and class margin of the two within NEAR_BAND;
    windows holding a detection within NEAR_BAND of a score threshold
    at most NEAR_SHARE of all; per window the two runs' tables agree
    (counts and nbox exact, areas within 1e-4) but where a detection
    sits within NEAR_BAND of a decision boundary, and on at most
    NEAR_SHARE of the windows; each camera decides alike up to its
    first step holding a differing window."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_cam, n_steps = 64, 8
    steps = n_steps + 1
    c = DEFAULT_GRID.n_cells * len(fleet_config(DEFAULT_GRID).zoom_levels)
    cfg = get_config("madeye-approx")
    anchor = {"det_cfg": cfg, "thresh": FRESH_THRESH,
              "det_params": det.detector_init(
                  np.random.default_rng(ANCHOR_SEED), cfg)}
    base = FleetRunSpec(provider="detector", n_cameras=n_cam,
                        n_steps=n_steps)
    fused = dataclasses.replace(base, shortlist_k=c, provider_kwargs=anchor)
    ua, ucounts, uobs, uraw = _anchor_run(monkeypatch, dataclasses.replace(
        base, provider_kwargs={**anchor, "fused": False}), steps, n_cam, c)
    fa, fcounts, fobs, fraw = _anchor_run(monkeypatch, fused, steps, n_cam,
                                          c)
    p = prepare_fleet_run(fused).provider
    assert ucounts == {k: steps for k in SEARCH_AND_ORACLE} | {
        "dense": steps * (c // p.chunk)
        * vit_dense_launches(cfg, n_cam * p.chunk),
        "flash_attention": steps * (c // p.chunk) * cfg.n_layers}
    assert fcounts == {k: steps for k in SEARCH_AND_ORACLE} | {
        "crop_patchify": steps,
        "dense": steps * vit_dense_launches(cfg, n_cam * c),
        "flash_attention": steps * cfg.n_layers}

    thresholds = tuple(float(x) for x in p.thresh) + (float(p.geo_thresh),)
    n_diff = n_near_t = 0
    first = torch.full((n_cam,), n_steps)
    for e in range(n_steps):
        a, b = uobs[e], fobs[e]
        differ = ((a.counts != b.counts).any(-1) | (a.nbox != b.nbox)
                  | ((a.areas - b.areas).abs() > 1e-4).any(-1))
        differ = differ.reshape(n_cam, c).cpu()
        score, margin = fraw[e]
        assert float((uraw[e][0] - score).abs().max()) < NEAR_BAND
        assert float((uraw[e][1] - margin).abs().max()) < NEAR_BAND
        near_t, near_other = near_boundary(
            score.reshape(-1, score.shape[-1]),
            margin.reshape(-1, margin.shape[-1]), thresholds,
            cfg.max_boxes)
        near_t = near_t.reshape(n_cam, c)
        near = near_t | near_other.reshape(n_cam, c)
        assert not bool((differ & ~near).any()), (
            f"step {e}: (camera, window) "
            f"{torch.nonzero(differ & ~near)[:8].tolist()} differ with no "
            f"detection near a decision boundary")
        n_diff += int(differ.sum())
        n_near_t += int(near_t.sum())
        first = torch.where(differ.any(-1) & (first == n_steps), e, first)
    total = n_cam * c * n_steps
    assert n_near_t <= NEAR_SHARE * total
    assert n_diff <= NEAR_SHARE * total
    for f in range(n_cam):
        s = int(first[f])
        for name in DECISIONS:
            assert torch.equal(getattr(ua.out, name)[:s, f],
                               getattr(fa.out, name)[:s, f]), (f, name)
