"""Episode runner: one Python loop over controller steps behind the
observation-provider seam.

The fleet episode (`run_fleet_episode`) is parameterized by a provider
that owns a carry (`init_carry`), per-step inputs (`scan_xs`, leading
[E]) and an `observe` hook turning (carry, controller state, inputs) into the
`FleetObs` the controller step consumes. Three providers ship:

  * `EpisodeTables` (`tables`) — the host-built path
    (`build_episode_tables`: numpy loops over the procedural scene and
    the teacher models, the observations serving/pipeline.run_madeye
    feeds the numpy MadEyeController), moved to the device once; every
    camera watches the one shared world. The substrate of the decision
    parity with the numpy controller, and `serve --fleet`'s default.
  * `SceneProvider` (`scene`) — per-camera scenes advance and are
    observed by the oracle pass inside the step; scene randomness is
    driven by the per-camera keys in `FleetState.rng`.
  * `DetectorProvider` (`detector`) — the scene path with the
    approximation model in the loop (paper §3.4): a search-coupled
    shortlist keeps the `shortlist_k` candidate windows reachable by the
    shape search, kernels/crop_patchify rasterizes them straight into
    ViT patch embeddings, one batched detector forward over the [F*K]
    crops scores them, and the controller ranks on those detections;
    the oracle only grades what it chose (acc_true). With a DistillSpec
    the provider also learns in the episode (paper §3.4, repro_torch
    .learn): per-camera heads (or whole networks) score the shortlist
    and train on teacher grades of the crops the budget sent, after
    every controller step. `fused=False` is the unfused reference: every
    window rendered to pixels and scored through the image-level
    detector forward, one slab of `chunk` windows at a time — the
    anchor the fused path is held against.

`materialize_scene_tables` records a scene episode's observation stream
(the `collect_obs` extra) as EpisodeTables the tables path replays.

The fleet axis splits over a mesh `data` axis (launch/mesh.py) through
each provider's `shard` hook: the fleet-shared EpisodeTables stay whole
(a per-camera [E, F] link trace is cut), scene state and parameters
are cut with the fleet, the detector's parameters stay whole. Each rank
runs the episode on its own cameras, and one gather per episode makes
every output whole again (`run_fleet_episode(mesh=...)`). That is exact
because no stage reads across cameras: per-camera keys, per-camera
learned heads, row-wise kernels. The hand-written kernels have no
DTensor sharding rules, which is why the episode runs on plain local
tensors rather than DTensors.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch.configs import DetectorConfig, get_smoke_config
from repro_torch.core import ewma
from repro_torch.core.rank import Workload
from repro_torch.core.tradeoff import BudgetConfig
from repro_torch.core.transport import ar1_mobile_trace
from repro_torch.data import SceneConfig, build_video
from repro_torch.devices import resolve_device
from repro_torch.distributed.collectives import gather_fleet
from repro_torch.distributed.sharding import tree_leaves, tree_map_with_path
from repro_torch.fleet.state import (
    FleetConfig,
    FleetState,
    FleetStatics,
    WorkloadSpec,
    fleet_statics,
    init_fleet,
    workload_spec,
)
from repro_torch.fleet.step import FleetObs, FleetStepOut, fleet_step
from repro_torch.kernels.crop_patchify.ops import crop_patchify
from repro_torch.launch.mesh import mesh_shape
from repro_torch.learn.loop import (
    distill_step,
    init_learn,
    merged_params,
)
from repro_torch.learn.pairs import (
    harvest_into_buffer,
    select_sent_windows,
    teacher_window_targets,
)
from repro_torch.learn.spec import normalize_distill
from repro_torch.models.detector import (
    detections_from_feats,
    detector_forward,
    detector_forward_tokens,
    detector_init,
    detector_neck_feats_tokens,
    patch_embed_params,
    params_from_numpy,
)
from repro_torch.obs.metrics import step_metrics
from repro_torch.obs.trace import span
from repro_torch.scene.observe import (
    TeacherArrays,
    detections_obs,
    grid_windows,
    observe_all_cells,
    teacher_arrays,
)
from repro_torch.scene.render import render_fleet_crops, render_noise
from repro_torch.scene.scene import (
    SceneFleetParams,
    SceneSpec,
    SceneState,
    advance_scene,
    init_scene,
    kind_mask,
    scene_fleet_params,
)
from repro_torch.serving.accuracy import detection_tables, workload_acc_table
from repro_torch.serving.pipeline import (
    ZOOM_LEVELS,
    _observation_from_tables,
)
from repro_torch.serving.transport import NetworkTrace

# FleetObs fields recorded by collect_obs (everything but the network
# leaves, which a provider carries separately as [E] / [E, F] traces)
_TABLE_FIELDS = ("counts", "areas", "centroid", "spread", "extent",
                 "nbox", "acc_true")


def shard_fleet(tree, mesh, axis: int = 0):
    """This rank's contiguous slice of every leaf's fleet axis (`axis`,
    length F): [F / n_data] cameras at the rank's coordinate on the mesh
    `data` axis (views, no copy). Ranks that differ only in `model` hold
    the same cameras. F must divide by n_data."""
    n = mesh_shape(mesh)["data"]
    f = tree_leaves(tree)[0].shape[axis]
    if f % n:
        raise ValueError(f"{f} cameras do not split evenly over the mesh's "
                         f"{n} data ranks")
    i = mesh.get_local_rank("data")
    cut = (slice(None),) * axis + (slice(i * (f // n), (i + 1) * (f // n)),)
    return tree_map_with_path(lambda _, x: x[cut], tree)


def _shard_link(x: torch.Tensor, mesh) -> torch.Tensor:
    """An [E] fleet-shared link trace stays whole; an [E, F] per-camera
    one is cut to this rank's cameras, or they would read other cameras'
    links."""
    return x if x.dim() == 1 else shard_fleet(x, mesh, axis=1)


class EpisodeTables(NamedTuple):
    """Host-built observation substrate on the run's device; every leaf
    leads with [E] steps and has no fleet axis: the whole fleet watches
    one world. mbps/rtt are [E] for a fleet-shared link or [E, F] per
    camera."""
    counts: torch.Tensor    # [E, N, Z, P]
    areas: torch.Tensor     # [E, N, Z, P]
    centroid: torch.Tensor  # [E, N, Z, 2]
    spread: torch.Tensor    # [E, N, Z]
    extent: torch.Tensor    # [E, N, Z]
    nbox: torch.Tensor      # [E, N, Z]
    acc_true: torch.Tensor  # [E, N, Z]
    mbps: torch.Tensor      # [E] or [E, F]
    rtt: torch.Tensor       # [E] or [E, F]

    @property
    def n_steps(self) -> int:
        return self.counts.shape[0]

    def init_carry(self, state: FleetState):
        return ()

    def scan_xs(self):
        return self

    def observe(self, cfg: FleetConfig, wl: WorkloadSpec, carry,
                state: FleetState, xs):
        """Step e's shared tables as the [F, N, Z, ...] FleetObs the
        step takes: `expand`ed views of the one [N, Z, ...] row, no
        copy."""
        f = state.step_idx.shape[0]
        *tabs, mbps, rtt = xs
        return carry, FleetObs(*(x.expand((f,) + x.shape) for x in tabs),
                               mbps=mbps, rtt=rtt)

    def shard(self, mesh):
        # the fleet-shared tables stay whole
        return self._replace(mbps=_shard_link(self.mbps, mesh),
                             rtt=_shard_link(self.rtt, mesh))

    def gather_carry(self, carry, gather):
        """The carry (empty) as it is."""
        return carry


@dataclass(frozen=True)
class SceneProvider:
    """Scene-backed observation provider. Build with
    `make_scene_provider` (which also returns the matching FleetState so
    the scene keys in `FleetState.rng` line up with the scene seeds)."""
    spec: SceneSpec             # static scene layout
    params: SceneFleetParams    # per-camera tensors [F, ...]
    teach: TeacherArrays        # per-pair teacher constants
    state0: SceneState          # initial object state [F, M, ...]
    windows: torch.Tensor       # [N * Z, 4] flattened FOV windows
    mbps: torch.Tensor          # [E] or [E, F] network trace
    rtt: torch.Tensor           # [E] or [E, F]
    stride: int                 # scene frames per controller step

    @property
    def n_steps(self) -> int:
        return self.mbps.shape[0]

    def init_carry(self, state: FleetState):
        return self.state0

    def scan_xs(self):
        return (self.mbps, self.rtt)

    def oracle(self, cfg: FleetConfig, wl: WorkloadSpec, sc: SceneState,
               state: FleetState):
        """Advance the scenes one controller step and run the oracle
        pass -> (scene state, SceneObs)."""
        with span("madeye/scene"):
            sc = advance_scene(self.spec, self.params, state.rng, sc,
                               state.step_idx, self.stride)
            o = observe_all_cells(self.spec, self.teach, self.params, sc,
                                  state.step_idx * self.stride,
                                  self.windows, task_id=wl.task_id,
                                  pair_idx=wl.pair_idx,
                                  n_zoom=len(cfg.zoom_levels),
                                  cam_salt=state.rng[:, 0])
        return sc, o

    def observe(self, cfg: FleetConfig, wl: WorkloadSpec, carry,
                state: FleetState, xs):
        mbps_t, rtt_t = xs
        sc, o = self.oracle(cfg, wl, carry, state)
        return sc, FleetObs(*o, mbps=mbps_t, rtt=rtt_t)

    def shard(self, mesh):
        # scene state and parameters are cut with the fleet; the teacher
        # constants and windows are shared
        return replace(self, state0=shard_fleet(self.state0, mesh),
                       params=shard_fleet(self.params, mesh),
                       mbps=_shard_link(self.mbps, mesh),
                       rtt=_shard_link(self.rtt, mesh))

    def gather_carry(self, carry, gather):
        """The carry (scene state) whole again, through `gather`."""
        return gather(carry)


def shortlist_windows(cfg: FleetConfig, state: FleetState,
                      neighbor8: torch.Tensor, k: int) -> torch.Tensor:
    """Search-coupled candidate shortlist: the [F, K] flattened window
    ids (cell * Z + zoom) worth rendering + scoring this step.

    The shape search only explores cells reachable from the camera's
    current state (paper §3.3): the carried shape, its 8-neighbor ring,
    and the top-EWMA cells. Cells are ranked by exactly that — shape >
    ring > normalized EWMA label, with a sqrt-staleness tiebreak — and
    the top K/Z cells contribute all Z zoom windows each. Ties go to the
    lower cell id (a stable descending sort), so the selection is a pure
    per-camera function of the state."""
    z = len(cfg.zoom_levels)
    if k <= 0 or k % z != 0:
        raise ValueError(f"shortlist k={k} must be a positive multiple "
                         f"of the {z} zoom levels (whole cells)")
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
                       stable=True).indices[:, :kc]                # [F, Kc]
    zs = torch.arange(z, device=cells.device)
    return (cells[:, :, None] * z + zs[None, None, :]).reshape(
        cells.shape[0], kc * z)


@dataclass(frozen=True)
class DetectorProvider:
    """Scene-backed provider with the approximation model in the loop:
    shortlisted candidate windows are rasterized into patch tokens by
    the crop_patchify kernel and scored by one batched detector forward
    per step. Build with `make_detector_provider`.

    fused=False is the unfused reference (exhaustive only): every window
    rendered to pixels (`render_fleet_crops`) and scored by the
    image-level `detector_forward`, `chunk` windows at a time; the fused
    path at shortlist_k = N*Z makes the same decisions.

    With `distill` set (a repro_torch.learn.DistillSpec) the provider
    LEARNS in the episode: a LearnState (per-camera trainable params,
    optimizer state, pair ring) joins the carry, the forward routes
    through the per-camera params, and after each fleet_step the `learn`
    hook harvests teacher pairs from the SENT crops and takes a
    cadence-gated optimizer step. distill=None runs the exact frozen
    episode."""
    scene: SceneProvider        # world + teachers (oracle feedback)
    det_cfg: DetectorConfig
    det_params: dict            # shared detector params (never written)
    thresh: torch.Tensor        # [P] per-pair score threshold
    geo_thresh: torch.Tensor    # [] score floor for zoom geometry
    noise: torch.Tensor         # [] render noise scale
    nbr8: torch.Tensor          # [N, N] 8-neighbor mask (shortlist ring)
    chunk: int                  # windows per render slab
    shortlist_k: int = 0        # windows scored per camera (0 = all)
    fused: bool = True          # fused fast path vs the unfused slab loop
    distill: object = None      # repro_torch.learn.DistillSpec | None

    @property
    def n_steps(self) -> int:
        return self.scene.n_steps

    @property
    def learns(self) -> bool:
        """True when the episode calls the `learn` hook."""
        return self.distill is not None

    def _effective_k(self) -> int:
        c = self.scene.windows.shape[0]
        k = self.shortlist_k
        return k if 0 < k < c else c

    def init_carry(self, state: FleetState):
        """(scene state, shared params), plus a fresh LearnState with
        distillation on: every call builds new per-camera tensors, so a
        discarded warm-up step leaks nothing into the episode."""
        if self.distill is None:
            return (self.scene.state0, self.det_params)
        lc = init_learn(self.distill, self.det_cfg, self.det_params,
                        state.step_idx.shape[0], self._effective_k())
        return (self.scene.state0, self.det_params, lc)

    def scan_xs(self):
        return self.scene.scan_xs()

    def observe(self, cfg: FleetConfig, wl: WorkloadSpec, carry,
                state: FleetState, xs):
        learn_on = self.distill is not None
        if learn_on:
            sc, dp, lc = carry
        else:
            sc, dp = carry
        mbps_t, rtt_t = xs
        p = self.scene
        dev = sc.pos.device
        kinds = torch.as_tensor(kind_mask(p.spec), device=dev)
        pair_cls = torch.as_tensor(wl.pair_cls, device=dev)
        res = self.det_cfg.img_res

        # oracle pass: only acc_true is used — the teachers grade the
        # camera's choices, they no longer feed its ranking
        sc, o = p.oracle(cfg, wl, sc, state)
        with span("madeye/noise"):
            frame = state.step_idx * p.stride
            noise_img = render_noise(state.rng, frame, res) * self.noise
        with span("madeye/detect"):
            if learn_on:
                dets, lc = self._score_learn(cfg, state, sc, dp, lc, kinds,
                                             noise_img)
            elif self.fused:
                dets = self._score_fused(cfg, state, sc, dp, kinds,
                                         noise_img)
            else:
                dets = self._score_chunked(sc, dp, kinds, noise_img)
            do = detections_obs(dets, p.windows, pair_cls, self.thresh,
                                self.geo_thresh, o.acc_true,
                                n_zoom=len(cfg.zoom_levels))
        obs = FleetObs(*do, mbps=mbps_t, rtt=rtt_t)
        return ((sc, dp, lc) if learn_on else (sc, dp)), obs

    def _shortlist_tokens(self, cfg, state, sc, dp, kinds, noise_img):
        """Shortlist -> fused crop->token kernel: (tokens [F, K, gg, D],
        shortlisted window indices [F, K], or None when K covers every
        window)."""
        p = self.scene
        c = p.windows.shape[0]
        k = self._effective_k()
        widx = None
        if k < c:
            widx = shortlist_windows(cfg, state, self.nbr8, k)
            wins = p.windows[widx]                          # [F, K, 4]
        else:
            wins = p.windows                                # shared [C, 4]
        tokens = crop_patchify(
            sc.pos, sc.size, kinds, sc.oid, wins,
            patch_embed_params(dp, self.det_cfg),
            patch=self.det_cfg.patch, res=self.det_cfg.img_res,
            min_visible=p.spec.min_visible, noise=noise_img,
            block_k=_auto_chunk(k, self.chunk))             # [F, K, gg, D]
        return tokens, widx

    def _score_fused(self, cfg, state, sc, dp, kinds, noise_img):
        """Shortlist -> fused crop->token kernel -> one [F*K] forward,
        detections scattered back to the full window axis."""
        tokens, widx = self._shortlist_tokens(cfg, state, sc, dp, kinds,
                                              noise_img)
        f, k = tokens.shape[:2]
        c = self.scene.windows.shape[0]
        dets = detector_forward_tokens(
            dp, self.det_cfg, tokens.reshape((f * k,) + tokens.shape[2:]))
        dets = type(dets)(*(x.reshape((f, k) + x.shape[1:]) for x in dets))
        return _scatter_dets(dets, widx, c)

    def _score_chunked(self, sc, dp, kinds, noise_img):
        """The unfused reference: per slab of `chunk` windows, render the
        [F, chunk] crops to pixels and score them with one
        detector_forward over [F * chunk] images; window index = slab *
        chunk + j. Peak pixel memory [F, chunk, res, res, 3]."""
        p = self.scene
        c = p.windows.shape[0]
        f = sc.pos.shape[0]
        slabs = []
        for s in range(0, c, self.chunk):
            crops = render_fleet_crops(
                sc.pos, sc.size, kinds, sc.oid,
                p.windows[s:s + self.chunk], res=self.det_cfg.img_res,
                min_visible=p.spec.min_visible, noise=noise_img)
            d = detector_forward(dp, self.det_cfg,
                                 crops.reshape((-1,) + crops.shape[2:]))
            slabs.append([x.reshape((f, -1) + x.shape[1:]) for x in d])
        return type(d)(*(torch.cat(xs, dim=1) for xs in zip(*slabs)))

    def _score_learn(self, cfg, state, sc, dp, lc, kinds, noise_img):
        """The fused fast path routed through the LEARNED per-camera
        params, staging the student payload for the pair harvest.

        Head-only mode: the shared frozen backbone+neck runs once over
        the flattened [F*K] shortlist (the frozen path's compute),
        per-camera head convs finish the forward, and the post-neck
        features are staged — training re-runs no backbone compute.
        Full-param mode: each camera's whole network scores its own
        crops (vmap over the fleet) and the patch tokens are staged.
        -> (detections on the full [F, C] window axis, LearnState)."""
        tokens, widx = self._shortlist_tokens(cfg, state, sc, dp, kinds,
                                              noise_img)
        f, k = tokens.shape[:2]
        c = self.scene.windows.shape[0]
        cfg_d = self.det_cfg
        if self.distill.head_only:
            feats = detector_neck_feats_tokens(
                dp, cfg_d, tokens.reshape((f * k,) + tokens.shape[2:]))
            payload = feats.reshape((f, k) + feats.shape[1:])
            dets = vmap(lambda heads, x: detections_from_feats(
                cfg_d, heads, x))(lc.params, payload)
        else:
            payload = tokens
            dets = vmap(lambda par, x: detector_forward_tokens(
                par, cfg_d, x))(lc.params, tokens)
        dets_full = _scatter_dets(dets, widx, c)
        if widx is None:
            widx = torch.arange(c, device=tokens.device).expand(f, c)
        return dets_full, lc._replace(staged=payload, staged_widx=widx)

    def learn(self, cfg: FleetConfig, wl: WorkloadSpec, carry,
              state: FleetState, out: FleetStepOut, e: int):
        """Post-step learning hook of step e: harvest teacher pairs from
        the crops the budget SENT, then take the cadence-gated optimizer
        step. `state` is the post-step controller state (step_idx already
        incremented: the observation frame is (step_idx - 1) * stride,
        and step_idx == e + 1, which gates the cadence on the host);
        `out` this step's FleetStepOut. Returns (carry', aux) with aux
        {"loss": [F] (-1.0 for skipped/idle cameras), "lr": [F]}. Every
        stage is row-wise per camera."""
        sc, dp, lc = carry
        p = self.scene
        sel_widx, sel_ok = select_sent_windows(
            out, len(cfg.zoom_levels), self.distill.harvest)
        boxes, classes, bvalid = teacher_window_targets(
            p.spec, p.teach, p.params, sc,
            (state.step_idx - 1) * p.stride, p.windows[sel_widx],
            self.det_cfg.max_boxes, state.rng[:, 0])
        lc = lc._replace(buf=harvest_into_buffer(
            lc.buf, lc.staged, lc.staged_widx, sel_widx, sel_ok,
            boxes, classes, bvalid))
        lc, aux = distill_step(self.distill, self.det_cfg, lc, e + 1)
        return (sc, dp, lc), aux

    def learned_params(self, carry, camera=None):
        """Full detector params from a learning episode's final carry:
        the per-camera trained subtree merged with the shared frozen
        rest. camera=None keeps the fleet axis on the trained leaves; an
        int selects one camera's checkpoint (ready for
        `save_detector_params`)."""
        if self.distill is None:
            raise ValueError("learned_params needs a distill-enabled "
                             "provider (distill=None runs frozen)")
        _, dp, lc = carry
        return merged_params(self.distill, dp, lc.params, camera)

    def shard(self, mesh):
        # the scene is cut with the fleet; the detector parameters (and
        # the grid's neighbour mask) are shared. With distillation on, the
        # per-camera learning state starts from the cut state (init_carry)
        return replace(self, scene=self.scene.shard(mesh))

    def gather_carry(self, carry, gather):
        """Scene state and learning state whole again; the shared
        detector parameters as they are."""
        sc, dp, *lc = carry
        return (gather(sc), dp, *(gather(x) for x in lc))


def _scatter_dets(dets, widx, c: int):
    """Shortlisted detections [F, K, ...] onto the full [F, C] window
    axis: un-shortlisted windows read as score-0 detections (empty under
    any positive threshold), so detections_obs and the step consume the
    same axis either way. widx None: K already covers every window."""
    if widx is None:
        return dets
    f = widx.shape[0]
    rows = torch.arange(f, device=widx.device)[:, None]

    def scatter(x):
        full = x.new_zeros((f, c) + x.shape[2:])
        full[rows, widx] = x
        return full

    return type(dets)(*(scatter(x) for x in dets))


# ---------------------------------------------------------------------------
# provider construction (the registry factories — fleet.api)
# ---------------------------------------------------------------------------

def build_episode_tables(video, workload: Workload, tables: dict,
                         budget: BudgetConfig, trace, *,
                         approx_miss: float = 0.12,
                         acc_table: np.ndarray | None = None,
                         max_steps: int | None = None,
                         device=None) -> EpisodeTables:
    """Materialize what the observe callback + the backend return at
    every (controller timestep, cell, zoom) — the exact observations
    serving/pipeline.run_madeye feeds the numpy controller — in numpy on
    the host, then move each leaf to `device` once."""
    grid = video.grid
    spec = workload_spec(workload)
    n, z_n, p_n = grid.n_cells, len(ZOOM_LEVELS), len(spec.pairs)
    if acc_table is None:
        acc_table = workload_acc_table(video, workload, tables, ZOOM_LEVELS)
    stride = max(1, int(round(video.fps / budget.fps)))
    frames = list(range(0, video.n_frames, stride))
    if max_steps is not None:
        frames = frames[:max_steps]
    e = len(frames)

    counts = np.zeros((e, n, z_n, p_n), np.float32)
    areas = np.zeros((e, n, z_n, p_n), np.float32)
    centroid = np.zeros((e, n, z_n, 2), np.float32)
    spread = np.zeros((e, n, z_n), np.float32)
    extent = np.zeros((e, n, z_n), np.float32)
    nbox = np.zeros((e, n, z_n), np.int32)
    acc_true = np.zeros((e, n, z_n), np.float32)
    mbps = np.zeros(e, np.float32)

    for ei, t in enumerate(frames):
        acc_true[ei] = acc_table[t]
        mbps[ei] = trace.observed_mbps(t)
        for c in range(n):
            for zi in range(z_n):
                o = _observation_from_tables(tables, workload, grid, t, c,
                                             zi, approx_miss)
                for pi, pair in enumerate(spec.pairs):
                    counts[ei, c, zi, pi] = o.counts.get(pair, 0)
                    areas[ei, c, zi, pi] = o.areas.get(pair, 0.0)
                k = o.box_centers.shape[0]
                nbox[ei, c, zi] = k
                if k:
                    centroid[ei, c, zi] = o.centroid
                    spread[ei, c, zi] = float(np.linalg.norm(
                        o.box_centers - o.centroid, axis=1).mean())
                    extent[ei, c, zi] = float(o.box_sizes.max())

    rtt = np.full(e, float(trace.rtt_s), np.float32)
    return EpisodeTables(*(torch.as_tensor(x, device=device) for x in (
        counts, areas, centroid, spread, extent, nbox, acc_true, mbps,
        rtt)))


def budget_from_config(cfg: FleetConfig) -> BudgetConfig:
    """The host-side BudgetConfig a FleetConfig mirrors, so the host
    tables and the step read identical constants (the inverse of
    `fleet_config` for the budget fields)."""
    return BudgetConfig(
        fps=cfg.fps, rotation_speed=cfg.rotation_speed,
        hop_degrees=cfg.hop_degrees, approx_infer_s=cfg.approx_infer_s,
        backend_infer_s=cfg.backend_infer_s, frame_bytes=cfg.frame_bytes,
        min_send=cfg.min_send, max_send=cfg.max_send,
        pipelined=cfg.pipelined)


def make_tables_provider(grid, workload: Workload, cfg: FleetConfig, *,
                         n_cameras: int, n_steps: int | None = None,
                         seed: int = 3, mbps: float = 24.0,
                         rtt_ms: float = 20.0, approx_miss: float = 0.12,
                         scene_fps: float = 15.0, video=None, tables=None,
                         trace=None, acc_table=None, device=None
                         ) -> tuple[EpisodeTables, FleetState]:
    """Host-built provider: numpy scene + teacher oracles recorded into
    EpisodeTables on `device` (every camera shares one world).

    Builds the substrate from `seed` (procedural scene at `scene_fps`,
    long enough for `n_steps` controller steps at cfg.fps, fixed
    mbps/rtt link) — or reuses prebuilt `video`/`tables`/`trace`/
    `acc_table` objects (the serving launcher does; those kwargs are
    in-memory only, not JSON-serializable). Runs on the CUDA card unless
    `device="cpu"`; raises without a card."""
    dev = resolve_device(device)
    budget = budget_from_config(cfg)
    if video is None:
        if n_steps is None:
            raise ValueError("tables provider needs n_steps (or a "
                             "prebuilt video=) to size the substrate")
        stride = max(1, int(round(scene_fps / cfg.fps)))
        video = build_video(grid, SceneConfig(fps=scene_fps, seed=seed),
                            (n_steps * stride + 2) / scene_fps)
    if tables is None:
        tables = detection_tables(video, workload)
    if trace is None:
        trace = NetworkTrace.fixed(mbps, rtt_ms, video.n_frames)
    ep = build_episode_tables(video, workload, tables, budget, trace,
                              approx_miss=approx_miss, acc_table=acc_table,
                              max_steps=n_steps, device=dev)
    return ep, init_fleet(grid, n_cameras, device=dev)


def fleet_network_traces(n_steps: int, n_cameras: int | None = None, *,
                         mbps=24.0, rtt_ms=20.0, seed: int | None = None,
                         device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-episode network tensors: fleet-shared [E] traces with
    n_cameras=None, else [E, F]. seed=None gives fixed links; an int
    seed gives every camera its own AR(1) trace with deep fades."""
    shape = (n_steps,) if n_cameras is None else (n_steps, n_cameras)
    base = np.broadcast_to(np.asarray(mbps, np.float32), shape[1:])
    rtt = np.broadcast_to(np.asarray(rtt_ms, np.float32), shape[1:]) / 1e3
    if seed is None:
        x = np.broadcast_to(base, shape).astype(np.float32)
    else:
        x = ar1_mobile_trace(n_steps, base,
                             np.random.default_rng(seed)).astype(np.float32)
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(np.broadcast_to(rtt, shape).astype(np.float32),
                            device=device))


def make_scene_provider(grid, workload: Workload, cfg: FleetConfig, *,
                        n_cameras: int, n_steps: int,
                        spec: SceneSpec | None = None, seed: int = 0,
                        scene_seeds=None, person_speed=1.2, car_speed=10.0,
                        churn=0.01, n_people=None, n_cars=None,
                        mbps=24.0, rtt_ms=20.0, net_seed: int | None = None,
                        seed_size: int = 6, device=None
                        ) -> tuple[SceneProvider, FleetState]:
    """Heterogeneous scene-backed provider + the matching fleet state.
    Scalar scene arguments broadcast; pass [F] arrays for per-camera
    heterogeneity. The FleetState carries fold_in(PRNGKey(seed),
    scene_seeds[f]) in `rng` — the keys the initial scene was drawn
    from."""
    if n_steps is None:
        raise ValueError("the scene provider needs n_steps")
    spec = spec or SceneSpec()
    params, rng = scene_fleet_params(
        spec, n_cameras, seed=seed, scene_seeds=scene_seeds,
        person_speed=person_speed, car_speed=car_speed, churn=churn,
        n_people=n_people, n_cars=n_cars, device=device)
    state0 = init_scene(spec, params, rng)
    sw = workload_spec(workload)
    net_mbps, net_rtt = fleet_network_traces(
        n_steps, None if np.isscalar(mbps) and np.isscalar(rtt_ms)
        and net_seed is None else n_cameras,
        mbps=mbps, rtt_ms=rtt_ms, seed=net_seed, device=device)
    provider = SceneProvider(
        spec=spec, params=params, teach=teacher_arrays(sw.pairs, device),
        state0=state0,
        windows=grid_windows(grid, cfg.zoom_levels, device=device),
        mbps=net_mbps, rtt=net_rtt,
        stride=max(1, int(round(spec.fps / cfg.fps))))
    state = init_fleet(grid, n_cameras, seed_size, rng=rng)
    return provider, state


def save_detector_params(path: str, params) -> str:
    """Write a detector params tree (nested dicts, and Swin's lists, of
    tensors or arrays) to .npz with '/'-joined keys — the checkpoint format both packages
    load. Returns the path written."""
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k in sorted(tree):
                k = str(k)
                if "/" in k or not k:
                    raise ValueError(
                        f"key {k!r} under {prefix or '<root>'!r} would "
                        f"not round-trip through '/'-joined npz names")
                walk(tree[k], f"{prefix}/{k}" if prefix else k)
        elif isinstance(tree, list) and prefix:
            for i, v in enumerate(tree):
                walk(v, f"{prefix}/{i}")
        elif not prefix:
            raise TypeError("detector params must be a dict tree, got "
                            f"{type(tree).__name__}")
        elif isinstance(tree, torch.Tensor):
            flat[prefix] = tree.detach().cpu().numpy()
        elif not hasattr(tree, "shape"):
            raise TypeError(f"leaf {prefix!r} is {type(tree).__name__}, "
                            f"not an array")
        else:
            flat[prefix] = np.asarray(tree)

    walk(params, "")
    np.savez(path, **flat)
    return path


def load_detector_params(path: str, device=None) -> dict:
    """Load a `save_detector_params` .npz back into the nested tree of
    float32 tensors on `device`."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return params_from_numpy(out, device)


def _auto_chunk(n_windows: int, default: int) -> int:
    """Largest divisor of n_windows that is <= default (>= 1)."""
    chunk = max(1, min(default, n_windows))
    while n_windows % chunk != 0:
        chunk -= 1
    return chunk


def make_detector_provider(grid, workload: Workload, cfg: FleetConfig, *,
                           n_cameras: int, n_steps: int,
                           det_cfg: DetectorConfig | None = None,
                           det_params=None, det_seed: int = 0, thresh=None,
                           geo_thresh: float | None = None,
                           noise: float = 0.05,
                           chunk: int | None = None,
                           shortlist_k: int | None = None,
                           fused: bool = True, distill=None, device=None,
                           **scene_kwargs
                           ) -> tuple[DetectorProvider, FleetState]:
    """Scene provider + the approximation detector scored in-step.

    det_cfg defaults to the madeye-approx smoke config (64 px crops).
    det_params: a params tree (tensors or arrays), a `.npz` checkpoint
    path, or None for fresh weights from torch.Generator(det_seed).
    `thresh` broadcasts to a per-pair [P] score threshold; left None it
    is 0.3 for fresh weights and 0.5 for given ones, and `geo_thresh`
    (zoom-geometry score floor) follows at +0.05. `shortlist_k` caps the
    windows rendered + scored per camera per step (a multiple of the
    zoom count; None scores all N*Z). `fused=False` picks the unfused
    reference (every window rendered to pixels and scored by the
    image-level forward; exhaustive only, no distillation). `chunk`
    bounds the render slab of the unfused path and of the fused path's
    plain version on the CPU (must divide N*Z; default one cell-row of
    zooms). `scene_kwargs` are make_scene_provider's knobs."""
    if det_cfg is None:
        det_cfg = get_smoke_config("madeye-approx")
    trained = det_params is not None
    if isinstance(det_params, (str, bytes)):
        det_params = load_detector_params(det_params, device)
    elif det_params is None:
        det_params = detector_init(torch.Generator().manual_seed(det_seed),
                                   det_cfg, device)
    else:
        det_params = params_from_numpy(det_params, device)
    if thresh is None:
        thresh = 0.5 if trained else 0.3
    if geo_thresh is None:
        geo_thresh = float(np.asarray(thresh).max()) + 0.05
    scene, state = make_scene_provider(
        grid, workload, cfg, n_cameras=n_cameras, n_steps=n_steps,
        device=device, **scene_kwargs)
    n_pairs = len(workload_spec(workload).pairs)
    c = scene.windows.shape[0]
    z = len(cfg.zoom_levels)
    if chunk is None:
        chunk = _auto_chunk(c, z * max(1, cfg.n_pan))
    elif c % chunk != 0:
        raise ValueError(
            f"chunk={chunk} must divide the {c} candidate windows "
            f"(n_cells * n_zoom) — a non-dividing slab would silently "
            f"fall back to rendering all windows at once")
    if shortlist_k is None:
        shortlist_k = c
    elif not (0 < shortlist_k <= c) or shortlist_k % z != 0:
        raise ValueError(
            f"shortlist_k={shortlist_k} must be a multiple of the "
            f"{z} zoom levels in [{z}, {c}] — the shortlist keeps whole "
            f"cells (all zooms of a kept cell are scored)")
    if not fused and shortlist_k < c:
        raise ValueError(
            "the chunked reference path (fused=False) is exhaustive-"
            f"only; drop shortlist_k={shortlist_k} or use the fused "
            "fast path")
    if shortlist_k < c and (float(np.min(np.asarray(thresh))) <= 0.0
                            or float(geo_thresh) <= 0.0):
        raise ValueError(
            "shortlisting needs strictly positive thresh/geo_thresh: "
            "un-shortlisted windows are scattered as score-0 "
            f"detections (got thresh={thresh!r}, "
            f"geo_thresh={geo_thresh!r})")
    distill = normalize_distill(distill)
    if distill is not None:
        if not fused:
            raise ValueError(
                "in-scan distillation rides the fused fast path (the "
                "student payload is staged from the fused forward); the "
                "chunked reference (fused=False) stays the frozen "
                "bit-exact anchor — drop distill or fused=False")
        if distill.harvest > grid.n_cells:
            raise ValueError(
                f"distill.harvest={distill.harvest} exceeds the "
                f"{grid.n_cells} grid cells — no step can send that many "
                f"distinct orientations")
    provider = DetectorProvider(
        scene=scene, det_cfg=det_cfg, det_params=det_params,
        thresh=torch.as_tensor(np.broadcast_to(
            np.asarray(thresh, np.float32), (n_pairs,)).copy(),
            device=device),
        geo_thresh=torch.tensor(geo_thresh, dtype=torch.float32,
                                device=device),
        noise=torch.tensor(noise, dtype=torch.float32, device=device),
        nbr8=fleet_statics(grid, device).neighbor8,
        chunk=chunk, shortlist_k=shortlist_k, fused=fused, distill=distill)
    return provider, state


# ---------------------------------------------------------------------------
# THE episode: one step loop for every provider
# ---------------------------------------------------------------------------

def episode_step(cfg: FleetConfig, wl: WorkloadSpec, statics: FleetStatics,
                 state: FleetState, provider, carry, e: int, *,
                 metrics=None, collect_obs: bool = False):
    """One controller step e: provider.observe, fleet_step, then (for a
    learning provider) provider.learn, and with `metrics` (a
    MetricsSpec) step_metrics. -> (state, carry, FleetStepOut, extras):
    extras holds "metrics" (the FleetMetrics dict, with distill_loss /
    distill_lr joining it on learning runs), "learn" (the learn aux) and
    with `collect_obs` "obs" (camera 0's observation tables, the
    _TABLE_FIELDS of its FleetObs) where they apply, else it is
    empty.

    With a tracer active or a torch.profiler recording
    (repro_torch.obs.trace), the step is the span `madeye/step` (arg
    `e`) and its phases the spans `madeye/scene` (scene advance and
    oracle pass), `madeye/noise`, `madeye/detect` (shortlist, crops,
    detector, tables), `madeye/controller` (fleet_step) and
    `madeye/learn`."""
    with span("madeye/step", e=e):
        xs = tuple(x[e] for x in provider.scan_xs())
        carry, obs = provider.observe(cfg, wl, carry, state, xs)
        with span("madeye/controller"):
            state2, out = fleet_step(cfg, wl, statics, state, obs)
        ex = {}
        if collect_obs:
            ex["obs"] = {f: getattr(obs, f)[0] for f in _TABLE_FIELDS}
        if getattr(provider, "learns", False):
            with span("madeye/learn"):
                carry, laux = provider.learn(cfg, wl, carry, state2, out, e)
            ex["learn"] = laux
        if metrics is not None:
            ex["metrics"] = step_metrics(metrics, cfg, provider, state,
                                         state2, obs, out)
            if "learn" in ex:
                ex["metrics"]["distill_loss"] = ex["learn"]["loss"]
                ex["metrics"]["distill_lr"] = ex["learn"]["lr"]
    return state2, carry, out, ex


def run_fleet_episode(cfg: FleetConfig, wl: WorkloadSpec,
                      statics: FleetStatics, state: FleetState, provider,
                      *, mesh=None, metrics=None, collect_obs: bool = False):
    """The episode: E controller steps carrying (state, provider carry).

    Returns (final state, FleetStepOut with leaves stacked [E, F, ...],
    extras, final carry). extras holds "metrics" (the FleetMetrics dict,
    leaves [E, F]) when `metrics` (a MetricsSpec) is on, "obs" (camera
    0's observation tables, leaves [E, N, Z, ...]) with `collect_obs`,
    and "learn" (the learn aux, leaves [E, F]) for a LEARNING provider
    (DetectorProvider with distill set), whose final carry holds the
    learned params (provider.learned_params(final_carry)). Prefer
    `repro_torch.fleet.api.run_fleet(spec)` unless composing
    providers/state yourself.

    With `mesh`, every rank of the mesh calls this with the same whole
    `state` and `provider`: the rank runs the episode on its cameras
    (`shard_fleet`, the provider's `shard` hook), then all-gathers over
    the mesh's `data` group every output with a fleet axis — the final
    state, the step outputs, metrics, learn extras and the carry's
    per-camera trees — so every rank returns what the unsharded call
    returns."""
    if metrics is not None and not metrics.enabled:
        metrics = None
    if mesh is not None:
        if collect_obs:
            raise ValueError("collect_obs records camera 0 of an unsharded "
                             "episode; run it without a mesh")
        state, provider = shard_fleet(state, mesh), provider.shard(mesh)
    carry = provider.init_carry(state)
    outs, exs = [], []
    for e in range(provider.n_steps):
        state, carry, out, ex = episode_step(cfg, wl, statics, state,
                                             provider, carry, e,
                                             metrics=metrics,
                                             collect_obs=collect_obs)
        outs.append(out)
        exs.append(ex)
    out = FleetStepOut(*(torch.stack(v) for v in zip(*outs)))
    ex = {name: {k: torch.stack([x[name][k] for x in exs])
                 for k in exs[0][name]} for name in exs[0]} if exs else {}
    if mesh is not None:
        group = mesh.get_group("data")
        state = gather_fleet(state, group)
        out = gather_fleet(out, group, axis=1)
        ex = gather_fleet(ex, group, axis=1)
        carry = provider.gather_carry(
            carry, lambda tree: gather_fleet(tree, group))
    return state, out, ex, carry


def materialize_scene_tables(cfg: FleetConfig, wl: WorkloadSpec,
                             statics: FleetStatics, state: FleetState,
                             provider: SceneProvider) -> EpisodeTables:
    """Record the observation stream camera 0 of `provider` sees as
    EpisodeTables the tables path can replay (on the provider's device).

    Runs the same full-fleet scene episode (not an F = 1 slice), so the
    recorded floats are the ones the scene provider feeds fleet_step: a
    homogeneous fleet's tables episode then decides exactly as its scene
    episode. For cheap replay tables where that does not matter, build
    the provider and state at n_cameras=1 and materialize that."""
    with torch.no_grad():
        _, _, ex, _ = run_fleet_episode(cfg, wl, statics, state, provider,
                                        collect_obs=True)
    rec = ex["obs"]
    mbps, rtt = provider.mbps, provider.rtt
    if mbps.dim() == 2:
        mbps = mbps[:, 0]
    if rtt.dim() == 2:
        rtt = rtt[:, 0]
    return EpisodeTables(mbps=mbps, rtt=rtt,
                         **{f: rec[f] for f in _TABLE_FIELDS})
