"""Procedural 360°-style scene simulator.

Replaces the paper's 50-video YouTube dataset (offline container): objects
of interest (people, cars) move through a 150°x75° panorama with class-
specific dynamics chosen to reproduce the paper's measured statistics —

  * people: waypoint random walks between points-of-interest clusters
    (unstructured motion, frequent direction changes — paper §5.2 notes
    people queries switch orientations more);
  * cars: lane traffic at fixed tilt bands with constant velocities
    (structured motion);
  * spawn/despawn keeps density stationary;
  * the resulting best-orientation dwell times (~5-6 s median) and
    neighbor-accuracy correlation (~0.8) are what the reference package's
    benchmarks/bench_scene_stats.py asserts against the paper's Figures
    3/7/9-11; this copy draws the same streams in the same order, so its
    videos are bit-equal (tests/test_torch_tables.py).

Everything is numpy struct-of-arrays; ground truth at any (orientation,
zoom) is exact — the simulator is the oracle the accuracy metrics need.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.scene.scene import CAR, PERSON


@dataclass
class SceneConfig:
    extent: tuple = (150.0, 75.0)     # degrees (pan, tilt)
    fps: int = 15
    n_people: int = 14
    n_cars: int = 8
    n_poi: int = 3                    # person points-of-interest
    person_speed: float = 1.2         # deg/s mean
    car_speed: float = 10.0           # deg/s mean
    # angular sizes are calibrated against the teacher profiles: at zoom 1
    # (60x30 deg FOV) a median person is ~0.13 apparent (strong models see
    # it, weak ones need zoom); a median car is ~0.12 wide
    person_size: tuple = (2.5, 5.5)   # height range (deg)
    car_size: tuple = (5.0, 9.0)      # width range (deg)
    lane_tilts: tuple = (20.0, 32.0, 44.0)
    seed: int = 0
    churn: float = 0.01               # per-step respawn probability


@dataclass
class Scene:
    cfg: SceneConfig
    t: int = 0
    # struct-of-arrays object state (filled in __post_init__)
    kind: np.ndarray = field(default=None)
    pos: np.ndarray = field(default=None)       # [N, 2] degrees
    vel: np.ndarray = field(default=None)       # [N, 2] deg/s
    size: np.ndarray = field(default=None)      # [N, 2] degrees (w, h)
    oid: np.ndarray = field(default=None)       # [N] unique ids
    active: np.ndarray = field(default=None)    # [N] bool
    waypoint: np.ndarray = field(default=None)  # [N, 2] person targets

    def __post_init__(self):
        cfg = self.cfg
        self.rng = np.random.default_rng(cfg.seed)
        n = cfg.n_people + cfg.n_cars
        self.kind = np.concatenate([
            np.full(cfg.n_people, PERSON), np.full(cfg.n_cars, CAR)])
        self.poi = self.rng.uniform(
            [15, 10], [cfg.extent[0] - 15, cfg.extent[1] - 10],
            (cfg.n_poi, 2))
        self.pos = np.zeros((n, 2))
        self.vel = np.zeros((n, 2))
        self.size = np.zeros((n, 2))
        self.oid = np.arange(n)
        self.active = np.ones(n, bool)
        self.waypoint = np.zeros((n, 2))
        self._next_id = n
        for i in range(n):
            self._spawn(i, initial=True)

    # ------------------------------------------------------------------
    def _spawn(self, i: int, initial: bool = False):
        cfg, rng = self.cfg, self.rng
        if self.kind[i] == PERSON:
            poi = self.poi[rng.integers(cfg.n_poi)]
            self.pos[i] = np.clip(
                poi + rng.normal(0, 8, 2), [1, 1],
                [cfg.extent[0] - 1, cfg.extent[1] - 1])
            self.waypoint[i] = self.poi[rng.integers(cfg.n_poi)]
            speed = max(0.2, rng.normal(cfg.person_speed, 0.4))
            d = self.waypoint[i] - self.pos[i]
            self.vel[i] = speed * d / max(np.linalg.norm(d), 1e-6)
            w = rng.uniform(*cfg.person_size)
            self.size[i] = (w * 0.45, w)          # people are tall
        else:
            lane = rng.choice(cfg.lane_tilts)
            direction = rng.choice([-1.0, 1.0])
            x0 = 0.0 if direction > 0 else cfg.extent[0]
            if initial:
                x0 = rng.uniform(0, cfg.extent[0])
            self.pos[i] = (x0, lane + rng.normal(0, 1.0))
            speed = max(2.0, rng.normal(cfg.car_speed, 2.5))
            self.vel[i] = (direction * speed, 0.0)
            w = rng.uniform(*cfg.car_size)
            self.size[i] = (w, w * 0.45)          # cars are wide
        if not initial:
            self.oid[i] = self._next_id
            self._next_id += 1
        self.active[i] = True

    # ------------------------------------------------------------------
    def step(self):
        """Advance the scene by one frame (1/fps seconds)."""
        cfg, rng = self.cfg, self.rng
        dt = 1.0 / cfg.fps
        self.t += 1
        self.pos += self.vel * dt

        for i in range(self.pos.shape[0]):
            if self.kind[i] == PERSON:
                d = self.waypoint[i] - self.pos[i]
                if np.linalg.norm(d) < 2.0:
                    self.waypoint[i] = self.poi[rng.integers(cfg.n_poi)] \
                        + rng.normal(0, 6, 2)
                    d = self.waypoint[i] - self.pos[i]
                speed = np.linalg.norm(self.vel[i])
                jitter = rng.normal(0, 0.3, 2)
                v = speed * d / max(np.linalg.norm(d), 1e-6) + jitter
                self.vel[i] = v / max(np.linalg.norm(v), 1e-6) * speed
                self.pos[i] = np.clip(self.pos[i], 0, cfg.extent)
                if rng.random() < cfg.churn * dt * cfg.fps:
                    self._spawn(i)
            else:
                out = (self.pos[i, 0] < -3.0
                       or self.pos[i, 0] > cfg.extent[0] + 3.0)
                if out:
                    self._spawn(i)

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Copy of the visible-object state at the current frame."""
        m = self.active
        return {
            "kind": self.kind[m].copy(),
            "pos": self.pos[m].copy(),
            "size": self.size[m].copy(),
            "oid": self.oid[m].copy(),
            "t": self.t,
        }
