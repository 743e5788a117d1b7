"""One fleet timestep: budget -> shape -> path -> zoom -> rank (Fig. 8).

Fixed-shape controller step over a [F, n_cells] fleet batch:

  _plan             exploration/transmission budget, closed form over
                    the static k in [min_send, max_send]
  shape search      evolve + resize the shape (shape_search_plain),
                    then drop cells until its induced-MST preorder walk
                    fits the time budget (budget_walk_plain)
  _zoom             per-cell zoom on box summary statistics
  _rank             predicted workload accuracy + stable ranking

Tie-breaking is first extremum / lower cell id / earlier path position.
The search's loops run with per-camera done masks.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from bench.reference import ewma
from bench.reference import shape_ops
from bench.reference.fleet_state import (
    NET_DEFAULT_MBPS,
    NET_WINDOW,
    FleetConfig,
    FleetState,
    FleetStatics,
    WorkloadSpec,
)
from bench.reference.shape_search import (
    budget_walk_plain,
    shape_search_plain,
)

INF = math.inf


class FleetObs(NamedTuple):
    """Per-timestep observation substrate: tables [F, N, Z, ...], one row
    per camera (the scene and detector providers), or `expand`ed views of
    one shared [N, Z, ...] row when the fleet watches one world (the
    tables provider: stride 0 on the fleet axis, no copy); mbps/rtt []
    for a shared link or [F] per camera. acc_true is always the oracle's
    grade."""
    counts: torch.Tensor    # [F, N, Z, P] approx-model count per pair
    areas: torch.Tensor     # [F, N, Z, P] summed box area per pair
    centroid: torch.Tensor  # [F, N, Z, 2] bbox centroid (scene degrees)
    spread: torch.Tensor    # [F, N, Z] box-center spread
    extent: torch.Tensor    # [F, N, Z] max box side
    nbox: torch.Tensor      # [F, N, Z] box count
    acc_true: torch.Tensor  # [F, N, Z] oracle workload accuracy
    mbps: torch.Tensor      # [] or [F] network sample this step
    rtt: torch.Tensor       # [] or [F]


class FleetStepOut(NamedTuple):
    explored: torch.Tensor    # [F, N] bool
    order: torch.Tensor       # [F, N] path order (-1 padded)
    n_explored: torch.Tensor  # [F]
    zooms: torch.Tensor       # [F, N] zoom index per cell
    sent: torch.Tensor        # [F, N] bool — shipped to the backend
    pred_acc: torch.Tensor    # [F, N] predicted workload accuracy
    path_time: torch.Tensor   # [F] seconds
    k_send: torch.Tensor      # [F]
    chosen: torch.Tensor      # [F] — top-ranked explored cell
    acc_chosen: torch.Tensor  # [F] oracle accuracy of the chosen cell


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [F, K], idx [F] -> x[f, idx[f]]."""
    return torch.gather(x, 1, idx[:, None])[:, 0]


# ---------------------------------------------------------------------------
# budget (closed form)
# ---------------------------------------------------------------------------

def _plan(cfg: FleetConfig, harmonic, rtt, train_acc, pred_var):
    dev = harmonic.device
    risk = (1.0 - train_acc) + pred_var
    # 1e-4 floor guard: values on the 0.20 boundary take one branch
    k_risk = torch.clamp(
        1 + torch.floor(risk / 0.20 + 1e-4).to(torch.int64),
        cfg.min_send, cfg.max_send)
    hop_time = cfg.hop_degrees / cfg.rotation_speed
    per_extra = max(hop_time, cfg.approx_infer_s)
    ts = cfg.timestep

    karr = torch.arange(cfg.min_send, cfg.max_send + 1, device=dev)
    kf = karr.to(torch.float32)[None, :]            # [1, K]
    send_time = rtt[:, None] + (cfg.frame_bytes * 8.0 * kf) \
        / (harmonic[:, None] * 1e6)
    backend = cfg.backend_infer_s * kf
    if cfg.pipelined:
        fits = (send_time <= ts) & (backend <= ts)
        t_arr = torch.where(
            fits, ts,
            ts - torch.clamp(send_time - ts, min=0.0)
            - torch.clamp(backend - ts, min=0.0))
    else:
        t_arr = ts - send_time - backend
    extra = (t_arr - cfg.approx_infer_s) / per_extra
    mc_arr = torch.where(
        t_arr > 0,
        1 + torch.floor(torch.clamp(extra, min=0.0) + 1e-4).to(torch.int64),
        1)                                          # [F, K]
    feasible = ((mc_arr >= karr[None, :])
                & (karr[None, :] <= k_risk[:, None])
                & (karr[None, :] > cfg.min_send))
    any_f = feasible.any(-1)
    best = torch.where(feasible, karr[None, :], -1).max(-1).values
    pos = torch.where(any_f, best - cfg.min_send, 0)
    k_send = torch.where(any_f, best, cfg.min_send)
    t_explore = _take(t_arr, pos)
    mc = _take(mc_arr, pos)
    max_cells = torch.where(any_f, mc, torch.clamp(mc, min=cfg.min_send))
    return k_send, torch.clamp(t_explore, min=0.0), max_cells


# ---------------------------------------------------------------------------
# zoom (on box summary statistics)
# ---------------------------------------------------------------------------

def _zoom(cfg: FleetConfig, statics: FleetStatics, state: FleetState,
          explored):
    """Returns (zoom_idx, zoomed_since) advanced for explored cells."""
    dt = cfg.timestep
    zi, zs = state.zoom_idx, state.zoomed_since
    timer = (zi > 0) & (zs + dt >= cfg.zoom_out_after)

    cluster = state.nb_spread + state.nb_extent
    off = torch.linalg.vector_norm(
        state.nb_centroid - statics.centers[None], dim=-1)
    z_geo = torch.zeros_like(zi)
    for i, z in enumerate(cfg.zoom_levels):
        fw = cfg.fov_scale * cfg.pan_step / z
        fh = cfg.fov_scale * cfg.tilt_step / z
        half = min(fw, fh) / 2.0
        fits = (cluster + off) <= cfg.margin * half
        z_geo = torch.where(fits, i, z_geo)

    z_new = torch.where(timer | ~state.nb_has, 0, z_geo)
    zs_new = torch.where((z_new > 0) & (zi > 0), zs + dt, 0.0)
    zi_out = torch.where(explored, z_new, zi)
    zs_out = torch.where(explored, zs_new, zs)
    return zi_out, zs_out


# ---------------------------------------------------------------------------
# rank (relative to the explored set)
# ---------------------------------------------------------------------------

def _rank(wl: WorkloadSpec, counts_g, areas_g, visits, explored):
    """counts_g/areas_g [F, N, P] at the chosen zoom; visits [F, N]
    (pre-update EWMA seen); explored [F, N]. -> pred_acc [F, N]."""
    def rel(x):
        mx = x.max(-1, keepdim=True).values
        return torch.where(mx > 0, x / torch.clamp(mx, min=1e-9), 0.0)

    total = None
    for q in range(len(wl.pair_idx)):
        cnt = torch.where(explored, counts_g[..., wl.pair_idx[q]], 0.0)
        area = torch.where(explored, areas_g[..., wl.pair_idx[q]], 0.0)
        task = wl.task_id[q]
        if task == 0:          # binary
            s = (cnt > 0).to(torch.float32)
        elif task == 1:        # count
            s = rel(cnt)
        elif task == 2:        # detect: count + area proxy
            s = 0.7 * rel(cnt) + 0.3 * rel(area)
        else:                  # agg_count: novelty-modulated
            novelty = 1.0 / torch.sqrt(1.0 + visits)
            s = rel(cnt) * (1.0 + novelty)
            sm = torch.where(explored, s, 0.0).max(-1, keepdim=True).values
            s = torch.where(sm > 0, s / torch.clamp(sm, min=1e-9), s)
        s = torch.where(explored, s, 0.0)
        total = s if total is None else total + s
    return total / len(wl.pair_idx)


def gather_at_zoom(x: torch.Tensor, zoom_idx: torch.Tensor) -> torch.Tensor:
    """Per-camera table x [F, N, Z, ...] (an expanded shared row too) at
    each cell's chosen zoom (zoom_idx [F, N]) -> [F, N, ...]."""
    f, n = zoom_idx.shape
    dev = zoom_idx.device
    return x[torch.arange(f, device=dev)[:, None],
             torch.arange(n, device=dev)[None, :], zoom_idx]


# ---------------------------------------------------------------------------
# the timestep
# ---------------------------------------------------------------------------

def fleet_step(cfg: FleetConfig, wl: WorkloadSpec, statics: FleetStatics,
               state: FleetState, obs: FleetObs
               ) -> tuple[FleetState, FleetStepOut]:
    f, n = state.shape.shape
    dev = state.shape.device
    arange_f = torch.arange(f, device=dev)
    cells = torch.arange(n, device=dev)

    # 0. network observation (harmonic-mean window)
    slot = state.net_count % NET_WINDOW
    samples = state.net_samples.clone()
    samples[arange_f, slot] = torch.clamp(
        torch.broadcast_to(obs.mbps, (f,)), min=1e-3)
    net_count = state.net_count + 1
    n_s = torch.clamp(net_count, max=NET_WINDOW)
    inv = torch.where(
        torch.arange(NET_WINDOW, device=dev)[None, :] < n_s[:, None],
        1.0 / torch.clamp(samples, min=1e-9), 0.0)
    harmonic = torch.where(n_s > 0, n_s / torch.clamp(inv.sum(-1), min=1e-9),
                           NET_DEFAULT_MBPS)
    rtt = torch.broadcast_to(obs.rtt, (f,))

    # 1. budget
    k_send, t_explore, max_cells = _plan(cfg, harmonic, rtt,
                                         state.train_acc, state.pred_var)

    # 2. shape: reseed on empty scene, else evolve + resize (+ scout)
    labels = ewma.labels(state.ewma, delta_weight=cfg.delta_weight)
    staleness = (state.step_idx[:, None] - state.last_visit).to(
        torch.float32)
    prev = state.shape

    reseed_center = torch.argmax(labels + 1e-4 * staleness, dim=-1)
    shape_reseed = shape_ops.seed_shape(statics, cfg, max_cells,
                                        reseed_center)

    evolved = shape_search_plain(cfg, statics, prev, labels,
                                 state.centroids, state.has_boxes,
                                 max_cells)
    if cfg.scout_every:
        scout_now = ((max_cells == 1)
                     & (state.step_idx % cfg.scout_every
                        == cfg.scout_every - 1))
        score = labels + 1e-3 * torch.sqrt(torch.clamp(staleness, min=0.0))
        score = torch.where(evolved, -INF, score)
        scout = torch.argmax(score, dim=-1)
        evolved = torch.where(scout_now[:, None],
                              shape_ops._onehot(scout, n), evolved)

    reseed = ~state.saw_objects
    shape = torch.where(reseed[:, None], shape_reseed, evolved)
    newly = torch.where(reseed[:, None], shape_reseed, shape & ~prev)
    zoom_idx = torch.where(newly, 0, state.zoom_idx)
    zoomed_since = torch.where(newly, 0.0, state.zoomed_since)
    state = state._replace(zoom_idx=zoom_idx, zoomed_since=zoomed_since)

    # 3. reachability: shrink until coverable in the exploration budget
    hop_s = cfg.pan_step / cfg.rotation_speed
    per_cell = max(0.0, cfg.approx_infer_s - hop_s)
    budget_s = torch.clamp(t_explore - cfg.approx_infer_s,
                           min=cfg.approx_infer_s + hop_s)
    shape, order, cnt, path_time = budget_walk_plain(
        cfg, statics, shape, state.current_cell, labels, budget_s, per_cell)
    explored = shape

    # path position per cell (for rank tie-breaking + feedback argmaxes)
    ordc = torch.clamp(order, min=0)
    idx = torch.where(cells[None, :] < cnt[:, None], ordc, n)
    pos = torch.full((f, n + 1), n, dtype=torch.int64, device=dev)
    pos = pos.scatter(1, idx, cells[None, :].expand(f, n))[:, :n]

    # 4. zoom per explored cell (driven by last timestep's boxes)
    zoom_idx, zoomed_since = _zoom(cfg, statics, state, explored)

    # 5. observe at (cell, chosen zoom)
    counts_g = gather_at_zoom(obs.counts, zoom_idx)      # [F, N, P]
    areas_g = gather_at_zoom(obs.areas, zoom_idx)
    o_centroid = gather_at_zoom(obs.centroid, zoom_idx)  # [F, N, 2]
    o_spread = gather_at_zoom(obs.spread, zoom_idx)
    o_extent = gather_at_zoom(obs.extent, zoom_idx)
    o_has = gather_at_zoom(obs.nbox, zoom_idx) > 0
    true_g = gather_at_zoom(obs.acc_true, zoom_idx)      # [F, N]

    # 6. rank explored orientations by predicted workload accuracy
    visits = state.ewma.seen
    pred = _rank(wl, counts_g, areas_g, visits, explored)

    # stable ranking by (-pred, path position): srank[c] = number of
    # explored cells strictly ahead of c
    better = ((pred[:, None, :] > pred[:, :, None])
              | ((pred[:, None, :] == pred[:, :, None])
                 & (pos[:, None, :] < pos[:, :, None])))
    srank = (better & explored[:, None, :]).sum(-1)
    sent = explored & (srank < k_send[:, None])

    # 7. state updates (EWMA labels, stale decay, geometry, feedback)
    step_idx = state.step_idx + 1
    last_visit = torch.where(explored, step_idx[:, None], state.last_visit)
    ew = ewma.update(state.ewma, explored, pred)
    ew = ewma.decay_unvisited(ew, explored, rate=cfg.stale_decay)

    has_boxes = torch.where(explored, o_has, state.has_boxes)
    centroids = torch.where((explored & o_has)[..., None], o_centroid,
                            state.centroids)
    nb_centroid = torch.where(explored[..., None], o_centroid,
                              state.nb_centroid)
    nb_spread = torch.where(explored, o_spread, state.nb_spread)
    nb_extent = torch.where(explored, o_extent, state.nb_extent)
    nb_has = torch.where(explored, o_has, state.nb_has)
    saw_objects = (explored & o_has).any(-1)

    # backend feedback: rank agreement on the truly-best explored cell
    k_cells = cnt
    mx_pred = torch.where(explored, pred, -INF).max(-1, keepdim=True).values
    best_pred = torch.argmin(
        torch.where(explored & (pred == mx_pred), pos, n + 1), dim=-1)
    mx_true = torch.where(explored, true_g, -INF).max(
        -1, keepdim=True).values
    best_true = torch.argmin(
        torch.where(explored & (true_g == mx_true), pos, n + 1), dim=-1)
    agree = (best_pred == best_true).to(torch.float32)
    train_acc = torch.where(k_cells > 1,
                            0.9 * state.train_acc + 0.1 * agree,
                            state.train_acc)

    kf = torch.clamp(k_cells, min=1).to(torch.float32)
    mean_p = torch.where(explored, pred, 0.0).sum(-1) / kf
    var_p = torch.where(explored, (pred - mean_p[:, None]) ** 2,
                        0.0).sum(-1) / kf
    pred_var = torch.where(k_cells > 1, var_p, 0.0)

    current_cell = torch.where(
        cnt > 0, _take(ordc, torch.clamp(cnt - 1, min=0)),
        state.current_cell)

    new_state = FleetState(
        ewma=ew, shape=shape, current_cell=current_cell,
        zoom_idx=zoom_idx, zoomed_since=zoomed_since,
        centroids=centroids, has_boxes=has_boxes,
        nb_centroid=nb_centroid, nb_spread=nb_spread,
        nb_extent=nb_extent, nb_has=nb_has,
        train_acc=train_acc, pred_var=pred_var,
        saw_objects=saw_objects, step_idx=step_idx,
        last_visit=last_visit, net_samples=samples,
        net_count=net_count, rtt=rtt, rng=state.rng)
    out = FleetStepOut(explored=explored, order=order, n_explored=cnt,
                       zooms=zoom_idx, sent=sent, pred_acc=pred,
                       path_time=path_time, k_send=k_send,
                       chosen=best_pred,
                       acc_chosen=_take(true_g, best_pred))
    return new_state, out
