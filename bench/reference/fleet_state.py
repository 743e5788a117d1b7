"""Fleet controller state + statics over a [F, n_cells] camera batch.

`FleetState` mirrors the mutable attributes of the single-camera
controller, every leaf with a leading fleet axis [F]. `FleetStatics`
packs the grid geometry the step needs (tensors on the run's device,
constant across an episode); `FleetConfig`/`WorkloadSpec` are hashable
host-side configs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from bench.reference import ewma
from bench.reference.grid import OrientationGrid
from bench.reference.path import prim_mst
from bench.reference.rank import TASKS, Workload
from bench.reference.search import SearchConfig, best_rect, seed_shape
from bench.reference.tradeoff import BudgetConfig
from bench.reference.zoom import ZoomConfig
from bench.reference.neighbor_score import geometry_arrays
from bench.reference import prng
from bench.reference.scene import OBJ_IDS

NET_WINDOW = 5
NET_DEFAULT_MBPS = 24.0
# last_visit sentinel for cells never explored: far enough in the past
# that staleness bonuses saturate immediately
NEVER_VISITED = -1000


# ---------------------------------------------------------------------------
# static configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FleetConfig:
    """Everything the step treats as a constant."""
    # grid
    n_pan: int = 5
    n_tilt: int = 5
    pan_step: float = 30.0
    tilt_step: float = 15.0
    fov_scale: float = 2.0
    zoom_levels: tuple = (1.0, 2.0, 3.0)
    # budget (mirrors core/tradeoff.BudgetConfig)
    fps: float = 15.0
    rotation_speed: float = 400.0
    hop_degrees: float = 30.0
    approx_infer_s: float = 0.0067
    backend_infer_s: float = 0.010
    frame_bytes: int = 25_000
    min_send: int = 1
    max_send: int = 4
    pipelined: bool = False
    # search (mirrors core/search.SearchConfig)
    base_threshold: float = 1.25
    threshold_growth: float = 1.25
    max_swaps: int = 8
    # zoom (mirrors core/zoom.ZoomConfig)
    zoom_out_after: float = 3.0
    margin: float = 0.7
    # controller (the initial seed size is init_fleet's argument)
    delta_weight: float = 0.5
    scout_every: int = 8
    stale_decay: float = 0.995

    @property
    def n_cells(self) -> int:
        return self.n_pan * self.n_tilt

    @property
    def timestep(self) -> float:
        return 1.0 / self.fps


def fleet_config(grid: OrientationGrid,
                 budget: BudgetConfig | None = None,
                 search_cfg: SearchConfig | None = None,
                 zoom_cfg: ZoomConfig | None = None,
                 **overrides) -> FleetConfig:
    """Build a FleetConfig from the host-side config objects."""
    budget = budget or BudgetConfig()
    search_cfg = search_cfg or SearchConfig()
    zoom_cfg = zoom_cfg or ZoomConfig()
    kw = dict(
        n_pan=grid.n_pan, n_tilt=grid.n_tilt,
        pan_step=grid.pan_step, tilt_step=grid.tilt_step,
        fov_scale=grid.fov_scale, zoom_levels=tuple(zoom_cfg.zoom_levels),
        fps=budget.fps, rotation_speed=budget.rotation_speed,
        hop_degrees=budget.hop_degrees,
        approx_infer_s=budget.approx_infer_s,
        backend_infer_s=budget.backend_infer_s,
        frame_bytes=budget.frame_bytes,
        min_send=budget.min_send, max_send=budget.max_send,
        pipelined=budget.pipelined,
        base_threshold=search_cfg.base_threshold,
        threshold_growth=search_cfg.threshold_growth,
        max_swaps=search_cfg.max_swaps,
        zoom_out_after=zoom_cfg.zoom_out_after, margin=zoom_cfg.margin,
    )
    kw.update(overrides)
    return FleetConfig(**kw)


class WorkloadSpec(NamedTuple):
    """Static query layout: queries[q] reads pair column pair_idx[q] of the
    observation tables and scores with task task_id[q] (index into TASKS).
    pair_cls maps each pair to its object class id."""
    pairs: tuple            # ((model, obj), ...) — distinct, table order
    pair_idx: tuple         # [Q] int — query -> pair column
    task_id: tuple          # [Q] int — query -> TASKS index
    pair_cls: tuple         # [P] int — pair -> object class (PERSON/CAR)


def workload_spec(workload: Workload) -> WorkloadSpec:
    pairs = []
    for q in workload.queries:
        if (q.model, q.obj) not in pairs:
            pairs.append((q.model, q.obj))
    return WorkloadSpec(
        pairs=tuple(pairs),
        pair_idx=tuple(pairs.index((q.model, q.obj))
                       for q in workload.queries),
        task_id=tuple(TASKS.index(q.task) for q in workload.queries),
        pair_cls=tuple(int(OBJ_IDS[obj]) for _, obj in pairs),
    )


# ---------------------------------------------------------------------------
# statics (tensors, constant across an episode)
# ---------------------------------------------------------------------------

class FleetStatics(NamedTuple):
    centers: torch.Tensor       # [N, 2] cell centers (degrees)
    dist: torch.Tensor          # [N, N] Chebyshev rotation distance
    neighbor8: torch.Tensor     # [N, N] bool — 8-connected lattice
    overlap: torch.Tensor       # [N, N] FOV overlap at zoom 1
    mst_adj: torch.Tensor       # [N, N] bool — full-grid MST edges
    d_center: torch.Tensor      # [N, N] euclidean center distance
    rect_w: torch.Tensor        # [N + 1] seed-rectangle width per size
    rect_h: torch.Tensor        # [N + 1] seed-rectangle height per size
    coords: torch.Tensor        # [N, 2] (pan_i, tilt_i) lattice coords
    nbr_order: torch.Tensor     # [N, N] cells by descending (dist, id)
                                # from each cell — DFS push order
    cell_x: torch.Tensor        # [N] cell centers, contiguous columns
    cell_y: torch.Tensor        # [N]  (the neighbor_score kernel's input)


def _rect_table(grid: OrientationGrid) -> tuple[np.ndarray, np.ndarray]:
    """best_rect evaluated for every size (seed lookup)."""
    n = grid.n_cells
    ws = np.ones(n + 1, np.int64)
    hs = np.ones(n + 1, np.int64)
    for size in range(n + 1):
        ws[size], hs[size] = best_rect(grid, size)
    return ws, hs


def fleet_statics(grid: OrientationGrid, device=None) -> FleetStatics:
    geo = geometry_arrays(grid)
    n = grid.n_cells
    mst = np.zeros((n, n), bool)
    for a, b in prim_mst(grid.angular_distance):
        mst[a, b] = mst[b, a] = True
    ws, hs = _rect_table(grid)
    coords = np.array([grid.cell_coords(i) for i in range(n)], np.int64)
    # static DFS push order: from u, all cells by descending rotation
    # distance, ties toward the higher id — popping then visits nearest
    # first with ties toward the lower id
    ids = np.arange(n)
    nbr_order = np.stack([
        np.lexsort((-ids, -grid.angular_distance[u])) for u in range(n)
    ]).astype(np.int64)

    def t(x, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    f32 = torch.float32
    return FleetStatics(
        centers=t(grid.centers, f32),
        dist=t(grid.angular_distance, f32),
        neighbor8=t(geo["neighbor8"]),
        overlap=t(geo["overlap"]),
        mst_adj=t(mst),
        d_center=t(geo["d_center"]),
        rect_w=t(ws), rect_h=t(hs),
        coords=t(coords),
        nbr_order=t(nbr_order),
        cell_x=t(geo["cell_x"]), cell_y=t(geo["cell_y"]),
    )


# ---------------------------------------------------------------------------
# per-camera state
# ---------------------------------------------------------------------------

class FleetState(NamedTuple):
    """Mirror of the controller's mutable state; leaves lead with [F].
    Integer leaves are int64 (torch's index type)."""
    ewma: ewma.EWMAState        # acc/delta/last/seen, each [F, N]
    shape: torch.Tensor         # [F, N] bool — current search shape
    current_cell: torch.Tensor  # [F] camera orientation
    zoom_idx: torch.Tensor      # [F, N]
    zoomed_since: torch.Tensor  # [F, N] f32 — seconds at > min zoom
    centroids: torch.Tensor     # [F, N, 2] — search geometry (sticky)
    has_boxes: torch.Tensor     # [F, N] bool
    nb_centroid: torch.Tensor   # [F, N, 2] — zoom geometry (last visit)
    nb_spread: torch.Tensor     # [F, N] — mean box dist to centroid
    nb_extent: torch.Tensor     # [F, N] — max box side
    nb_has: torch.Tensor        # [F, N] bool — boxes seen at last visit
    train_acc: torch.Tensor     # [F] — backend-reported approx accuracy
    pred_var: torch.Tensor      # [F] — variance of last predictions
    saw_objects: torch.Tensor   # [F] bool
    step_idx: torch.Tensor      # [F]
    last_visit: torch.Tensor    # [F, N]
    net_samples: torch.Tensor   # [F, NET_WINDOW] observed mbps
    net_count: torch.Tensor     # [F] — filled window slots
    rtt: torch.Tensor           # [F] f32
    rng: torch.Tensor           # [F, 2] per-camera threefry key words


def init_fleet(grid: OrientationGrid, n_cameras: int,
               seed_size: int = 6, *, seed: int = 0,
               cam_seeds=None, rng=None, device=None) -> FleetState:
    """Initial conditions of every camera's controller.

    Camera f's key is fold_in(PRNGKey(seed), cam_seeds[f]) (cam_seeds
    defaults to arange) — derived from the camera's own seed, never from
    its position in the fleet, so its stream is independent of fleet
    size. Pass `rng` ([F, 2] keys) to install already-derived camera
    keys instead (make_scene_provider does)."""
    if n_cameras < 1:
        raise ValueError(f"n_cameras must be >= 1, got {n_cameras}")
    n = grid.n_cells
    f = n_cameras
    if rng is None:
        if cam_seeds is None:
            cam_seeds = np.arange(f)
        cam_seeds = np.broadcast_to(np.asarray(cam_seeds, np.int64), (f,))
        rng = prng.fold_in(prng.PRNGKey(seed, device),
                           torch.as_tensor(cam_seeds.copy(), device=device))
    elif rng.shape[0] != f:
        raise ValueError(f"rng has {rng.shape[0]} keys for {f} cameras")
    device = rng.device
    shape0 = np.asarray(seed_shape(grid, seed_size), bool)
    cur0 = int(np.flatnonzero(shape0)[0])

    def z(*s, dtype=torch.float32):
        return torch.zeros((f, *s), dtype=dtype, device=device)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    i64 = torch.int64
    return FleetState(
        ewma=ewma.EWMAState(z(n), z(n), z(n), z(n)),
        shape=torch.as_tensor(shape0, device=device).expand(f, n).clone(),
        current_cell=full((f,), cur0, i64),
        zoom_idx=z(n, dtype=i64),
        zoomed_since=z(n),
        centroids=z(n, 2),
        has_boxes=z(n, dtype=torch.bool),
        nb_centroid=z(n, 2),
        nb_spread=z(n),
        nb_extent=z(n),
        nb_has=z(n, dtype=torch.bool),
        train_acc=full((f,), 0.85, torch.float32),
        pred_var=full((f,), 0.25, torch.float32),
        saw_objects=torch.ones((f,), dtype=torch.bool, device=device),
        step_idx=z(dtype=i64),
        last_visit=full((f, n), NEVER_VISITED, i64),
        net_samples=z(NET_WINDOW),
        net_count=z(dtype=i64),
        rtt=full((f,), 0.02, torch.float32),
        rng=rng,
    )
