"""Exploration-vs-transmission balancer (paper §3.3).

Each timestep splits into (a) rotating through + approx-scoring explored
orientations and (b) sending the top-k to the backend + running the
workload there; (b) does not overlap (a) because transmission is governed
by global ranks over everything explored.

MadEye sizes k from how much it trusts its approximation models — low
training accuracy or high variance in last-step predictions means ranks
are risky, so send more frames for ground truth — then spends whatever
budget remains on exploration.

Network estimate = harmonic mean of the last 5 transfer rates (robust to
outliers, per adaptive-streaming practice [106]).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class NetworkEstimator:
    window: int = 5
    samples_mbps: list = field(default_factory=list)
    rtt_s: float = 0.02

    def observe(self, mbps: float, rtt_s: float | None = None):
        self.samples_mbps.append(max(mbps, 1e-3))
        if len(self.samples_mbps) > self.window:
            self.samples_mbps.pop(0)
        if rtt_s is not None:
            self.rtt_s = rtt_s

    @property
    def harmonic_mbps(self) -> float:
        if not self.samples_mbps:
            return 24.0
        s = np.asarray(self.samples_mbps)
        return float(len(s) / np.sum(1.0 / s))

    def transfer_time(self, n_bytes: int) -> float:
        return self.rtt_s + (n_bytes * 8) / (self.harmonic_mbps * 1e6)


@dataclass
class BudgetConfig:
    fps: float = 15.0
    rotation_speed: float = 400.0     # degrees/sec
    hop_degrees: float = 30.0         # grid step (matches OrientationGrid)
    approx_infer_s: float = 0.0067    # EfficientDet-D0-class on edge GPU
    backend_infer_s: float = 0.010    # workload inference per frame (TensorRT)
    frame_bytes: int = 25_000         # delta-encoded orientation frame
    min_send: int = 1
    max_send: int = 4
    # Beyond-paper optimization (EXPERIMENTS.md §Perf): pipeline stages
    # across timesteps — the radio transmits step t's frames while the
    # motor explores step t+1. Each stage must fit a timestep, but they
    # no longer compete for the same budget. Default False = paper-strict
    # serial accounting ("transmission ... does not overlap exploration").
    pipelined: bool = False

    @property
    def timestep(self) -> float:
        return 1.0 / self.fps


def frames_to_send(train_acc: float, pred_variance: float,
                   cfg: BudgetConfig) -> int:
    """Risk-adjusted k. Paper example: 85% training accuracy and 25%
    variance -> at least 2 frames."""
    risk = (1.0 - train_acc) + pred_variance
    # 1e-4 guard: the floor cut must not flip with float precision (the
    # initial 0.15 + 0.25 risk lands exactly on a 0.20 boundary, and the
    # f32 fleet controller must take the same branch as this f64 path)
    k = 1 + int(np.floor(risk / 0.20 + 1e-4))
    return int(np.clip(k, cfg.min_send, cfg.max_send))


def exploration_budget(k_send: int, net: NetworkEstimator,
                       cfg: BudgetConfig) -> tuple[float, int]:
    """Time left for exploring after sending k frames + backend inference,
    and the max shape size that fits it.

    Exploration is pipelined with approx inference (paper §3.3), so each
    extra orientation costs max(rotation_hop, approx_infer); we charge the
    conservative sum of one hop + one inference.
    """
    send_time = net.transfer_time(cfg.frame_bytes * k_send)
    backend = cfg.backend_infer_s * k_send
    if cfg.pipelined:
        # stages overlap across timesteps; exploration owns the timestep
        # as long as send/backend each fit one timestep on their own
        t_explore = cfg.timestep if (send_time <= cfg.timestep
                                     and backend <= cfg.timestep) else \
            cfg.timestep - max(0.0, send_time - cfg.timestep) \
            - max(0.0, backend - cfg.timestep)
    else:
        t_explore = cfg.timestep - send_time - backend
    hop_time = cfg.hop_degrees / cfg.rotation_speed
    # rotation overlaps approx inference on the previous capture (§3.3
    # "pipelines its exploration ... with the running of approximation
    # models"), so an extra cell costs the max of the two stages
    per_extra = max(hop_time, cfg.approx_infer_s)
    # first cell is the camera's current orientation: inference only
    extra = (t_explore - cfg.approx_infer_s) / per_extra
    max_cells = 1 + int(max(0, np.floor(extra + 1e-4))) if t_explore > 0 \
        else 1
    return max(t_explore, 0.0), max_cells


def plan_timestep(train_acc: float, pred_variance: float,
                  net: NetworkEstimator, cfg: BudgetConfig):
    """-> (k_send, t_explore_s, max_shape_cells).

    The risk-derived k is lowered until the residual budget can still
    explore at least k orientations — sending more ground-truth frames is
    pointless if it starves the exploration that finds them (the paper's
    explore-vs-transmit tension, resolved coherently)."""
    k = frames_to_send(train_acc, pred_variance, cfg)
    while k > cfg.min_send:
        t_explore, max_cells = exploration_budget(k, net, cfg)
        if max_cells >= k:
            return k, t_explore, max_cells
        k -= 1
    t_explore, max_cells = exploration_budget(k, net, cfg)
    return k, t_explore, max(max_cells, k)
