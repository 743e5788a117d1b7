"""One controller step of the detector fleet, worked out again in plain
PyTorch, stage by stage, from a cell's files and its seed.

`build_world` derives everything a run starts from: the scene layout and
per-camera parameters, the teacher constants, the windows, the
controller's configuration and geometry, the initial controller and
scene state and (distillation on) the initial learning state. The stage
functions each take a step's inputs and return what that stage gives:

  advance     the scene advanced one controller step
  oracle      the oracle's grade of every window (acc_true [F, N, Z])
  detect      shortlist -> the configured model's reference from the
              shortlisted windows and the noise (its module's
              `reference_detect`) -> the detections and the
              observation tables they make
  tables      detections -> observation tables
  control     fleet_step on given observations
  learn       pair harvest from the sent crops + the head-only update

The benchmark hands the same weights to the program and to `detect`.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.func import vmap

from bench.reference import ewma
from bench.reference.detector import detections_from_feats
from bench.reference.fleet_state import (
    FleetConfig,
    FleetState,
    fleet_config,
    fleet_statics,
    init_fleet,
    workload_spec,
)
from bench.reference.fleet_step import FleetObs, fleet_step
from bench.reference.grid import DEFAULT_GRID, OrientationGrid
from bench.reference.learn_loop import DistillSpec, distill_step, init_learn
from bench.reference.learn_pairs import (
    harvest_into_buffer,
    select_sent_windows,
    teacher_window_targets,
)
from bench.reference.observe import (
    detections_obs,
    grid_windows,
    observe_all_cells,
    teacher_arrays,
)
from bench.reference.rank import Query, Workload
from bench.reference.render import render_noise
from bench.reference.scene import (
    SceneSpec,
    advance_scene,
    init_scene,
    kind_mask,
    scene_fleet_params,
)
from bench.reference.tradeoff import BudgetConfig


class World(NamedTuple):
    """What a run of one cell starts from (tensors on one device)."""
    model: Any                  # the cell's model module
    det_cfg: Any                # its sizes object
    spec: SceneSpec
    params: Any                 # SceneFleetParams
    teach: Any                  # TeacherArrays
    windows: torch.Tensor       # [C, 4]
    cfg: FleetConfig
    statics: Any                # FleetStatics
    wl: Any                     # WorkloadSpec
    state0: FleetState
    scene0: Any                 # SceneState
    stride: int
    kinds: torch.Tensor         # [M]
    pair_cls: torch.Tensor      # [P]
    thresh: torch.Tensor        # [P]
    geo_thresh: torch.Tensor    # []
    noise: float
    shortlist_k: int
    block_k: int
    mbps: float
    rtt_s: float
    distill: DistillSpec | None


def _divisor_at_most(n: int, cap: int) -> int:
    chunk = max(1, min(cap, n))
    while n % chunk:
        chunk -= 1
    return chunk


def build_world(model, det_cfg, traffic: dict, seed: int, device,
                distill: dict | None) -> World:
    """The run's starting point from the model module, its sizes object
    `det_cfg` (with at least `img_res`, `max_boxes` and `score_thresh`),
    the traffic mix and the seed."""
    grid = (OrientationGrid(**traffic["grid"]) if traffic.get("grid")
            else DEFAULT_GRID)
    workload = Workload(tuple(Query(*q) for q in traffic["workload"]))
    cfg = fleet_config(grid, BudgetConfig(fps=traffic["fps"]))
    spec = SceneSpec(**traffic["scene"])
    f = traffic["n_cameras"]
    params, rng = scene_fleet_params(spec, f, seed=seed, device=device)
    wl = workload_spec(workload)
    windows = grid_windows(grid, cfg.zoom_levels, device=device)
    thresh = det_cfg.score_thresh
    return World(
        model=model, det_cfg=det_cfg, spec=spec, params=params,
        teach=teacher_arrays(wl.pairs, device), windows=windows, cfg=cfg,
        statics=fleet_statics(grid, device), wl=wl,
        state0=init_fleet(grid, f, 6, rng=rng),
        scene0=init_scene(spec, params, rng),
        stride=max(1, int(round(spec.fps / cfg.fps))),
        kinds=torch.as_tensor(kind_mask(spec), device=device),
        pair_cls=torch.as_tensor(wl.pair_cls, device=device),
        thresh=torch.full((len(wl.pairs),), thresh, dtype=torch.float32,
                          device=device),
        geo_thresh=torch.tensor(thresh + 0.05, dtype=torch.float32,
                                device=device),
        noise=traffic["render_noise"], shortlist_k=traffic["shortlist_k"],
        block_k=_divisor_at_most(traffic["shortlist_k"],
                                 len(cfg.zoom_levels) * cfg.n_pan),
        mbps=traffic["network"]["mbps"],
        rtt_s=traffic["network"]["rtt_ms"] / 1e3,
        distill=None if distill is None else DistillSpec(**distill))


def initial_learn(world: World, weights):
    return init_learn(world.distill, world.det_cfg, weights,
                      world.state0.step_idx.shape[0], world.shortlist_k,
                      world.model.neck_shape(world.det_cfg))


def advance(world: World, state: FleetState, sc):
    return advance_scene(world.spec, world.params, state.rng, sc,
                         state.step_idx, world.stride)


def oracle(world: World, state: FleetState, sc) -> torch.Tensor:
    """acc_true [F, N, Z] of the advanced scene `sc`."""
    return observe_all_cells(
        world.spec, world.teach, world.params, sc,
        state.step_idx * world.stride, world.windows,
        task_id=world.wl.task_id, pair_idx=world.wl.pair_idx,
        n_zoom=len(world.cfg.zoom_levels),
        cam_salt=state.rng[:, 0]).acc_true


def shortlist_windows(cfg: FleetConfig, state: FleetState,
                      neighbor8: torch.Tensor, k: int) -> torch.Tensor:
    """The [F, K] flattened window ids (cell * Z + zoom) scored this
    step: cells ranked shape > 8-neighbour ring > normalized EWMA label,
    with a sqrt-staleness tiebreak (a stable descending sort: ties to
    the lower cell id), all Z zooms of the top K/Z cells."""
    z = len(cfg.zoom_levels)
    kc = k // z
    labels = ewma.labels(state.ewma, delta_weight=cfg.delta_weight)
    lnorm = labels / torch.clamp(labels.max(-1, keepdim=True).values,
                                 min=1e-9)
    stale = torch.sqrt(torch.clamp(
        (state.step_idx[:, None] - state.last_visit).to(torch.float32),
        min=0.0))
    shape = state.shape
    ring = (shape.to(torch.float32) @ neighbor8.to(torch.float32)) > 0
    score = (4.0 * shape + 2.0 * (ring & ~shape)
             + lnorm + 1e-3 * stale)
    cells = torch.sort(score, dim=-1, descending=True,
                       stable=True).indices[:, :kc]
    zs = torch.arange(z, device=cells.device)
    return (cells[:, :, None] * z + zs[None, None, :]).reshape(
        cells.shape[0], kc * z)


def _scatter(dets, widx: torch.Tensor, c: int):
    """[F, K, ...] detections onto the [F, C] window axis (the windows
    not shortlisted read as score-0 detections)."""
    rows = torch.arange(widx.shape[0], device=widx.device)[:, None]

    def scatter(x):
        full = x.new_zeros((widx.shape[0], c) + x.shape[2:])
        full[rows, widx] = x
        return full

    return type(dets)(*(scatter(x) for x in dets))


def detect(world: World, weights, state: FleetState, sc, acc_true,
           heads=None):
    """Shortlist -> the model's reference detections -> observation
    tables. `heads` [F, ...] (distillation on) are each camera's own
    heads over the shared backbone's post-neck features, which the
    model then gives in place of its detections. -> (SceneObs tables
    on the whole [F, N, Z] window axis, shortlist [F, K], the
    detections on the [F, C] window axis)."""
    cfg_d = world.det_cfg
    c = world.windows.shape[0]
    frame = state.step_idx * world.stride
    noise_img = render_noise(state.rng, frame, cfg_d.img_res) * world.noise
    widx = shortlist_windows(world.cfg, state, world.statics.neighbor8,
                             world.shortlist_k)
    dets = world.model.reference_detect(
        cfg_d, weights, sc, world.kinds, world.windows[widx], noise_img,
        min_visible=world.spec.min_visible, block_k=world.block_k,
        feats_only=heads is not None)
    if heads is not None:
        dets = vmap(lambda h, x: detections_from_feats(cfg_d, h, x))(
            heads, dets)
    dets = _scatter(dets, widx, c)
    return tables(world, dets, acc_true), widx, dets


def tables(world: World, dets, acc_true):
    """Detections on the [F, C] window axis -> the observation tables."""
    return detections_obs(dets, world.windows, world.pair_cls,
                          world.thresh, world.geo_thresh, acc_true,
                          n_zoom=len(world.cfg.zoom_levels))


def control(world: World, state: FleetState, obs):
    """fleet_step on the observation tables `obs` (the first seven
    FleetObs fields) -> (state', FleetStepOut)."""
    dev = state.step_idx.device
    fo = FleetObs(*obs[:7], mbps=torch.tensor(world.mbps, device=dev),
                  rtt=torch.tensor(world.rtt_s, device=dev))
    return fleet_step(world.cfg, world.wl, world.statics, state, fo)


def learn(world: World, lc, state2: FleetState, out, sc, e: int):
    """The post-step update of step e: harvest the sent crops' staged
    features into the ring, then the cadence-gated AdamW step. `lc`
    holds this step's staged features; `state2` is the post-step state.
    -> (learning state', per-camera loss [F], -1.0 where skipped)."""
    d = world.distill
    sel_widx, sel_ok = select_sent_windows(
        out, len(world.cfg.zoom_levels), d.harvest)
    boxes, classes, bvalid = teacher_window_targets(
        world.spec, world.teach, world.params, sc,
        (state2.step_idx - 1) * world.stride, world.windows[sel_widx],
        world.det_cfg.max_boxes, state2.rng[:, 0])
    lc = lc._replace(buf=harvest_into_buffer(
        lc.buf, lc.staged, lc.staged_widx, sel_widx, sel_ok, boxes,
        classes, bvalid))
    lc, aux = distill_step(d, world.det_cfg, lc, e + 1)
    return lc, aux["loss"]
