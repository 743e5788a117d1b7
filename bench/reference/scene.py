"""Device-resident procedural scene over a [F, max_objects] fleet batch.

POI random-walk people, lane-traffic cars, churn respawn and stationary
density as pure functions of a `SceneState`, driven by per-camera
threefry keys derived as fold_in(camera_key, frame) — reproducible and
independent of fleet size (prng reproduces the
reference streams).

  * `SceneSpec`        — static constants (extent, slot layout, spawn
                         size ranges, teacher-noise knobs);
  * `SceneFleetParams` — per-camera tensors (speeds, churn, POI layout,
                         density via the `enabled` slot mask);
  * `scene_step`       — one frame for the whole fleet.

Object identity (`oid`) survives respawns: a respawned slot takes the
camera's next fresh id.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from bench.reference import prng

PERSON, CAR = 0, 1
OBJ_IDS = {"person": PERSON, "car": CAR}

_POI_SALT = 0x5CE7E


@dataclass(frozen=True)
class SceneSpec:
    """Static scene layout. Slots [0, max_people) are people, the rest
    cars; per-camera density is the `enabled` mask."""
    extent: tuple = (150.0, 75.0)
    fps: int = 15
    max_people: int = 14
    max_cars: int = 8
    n_poi: int = 3
    person_size: tuple = (2.5, 5.5)
    car_size: tuple = (5.0, 9.0)
    lane_tilts: tuple = (20.0, 32.0, 44.0)
    # observation model (teacher response + approximation-model misses)
    min_visible: float = 0.25
    miss_rate: float = 0.12
    flicker: float = 0.4
    flicker_bucket: int = 3

    @property
    def max_objects(self) -> int:
        return self.max_people + self.max_cars

    @classmethod
    def from_config(cls, cfg, **overrides) -> "SceneSpec":
        """Geometry and layout of a numpy `data.scene.SceneConfig` as a
        static spec. Dynamics (person_speed, car_speed, churn) are
        per-camera tensors in SceneFleetParams, not spec fields: use
        `fleet_from_config` to port a whole SceneConfig."""
        kw = dict(extent=tuple(cfg.extent), fps=cfg.fps,
                  max_people=cfg.n_people, max_cars=cfg.n_cars,
                  n_poi=cfg.n_poi, person_size=tuple(cfg.person_size),
                  car_size=tuple(cfg.car_size),
                  lane_tilts=tuple(cfg.lane_tilts))
        kw.update(overrides)
        return cls(**kw)


class SceneFleetParams(NamedTuple):
    """Per-camera scene heterogeneity; every leaf leads with [F]."""
    person_speed: torch.Tensor   # [F] deg/s mean
    car_speed: torch.Tensor      # [F] deg/s mean
    churn: torch.Tensor          # [F] per-step respawn probability
    poi: torch.Tensor            # [F, n_poi, 2] person points-of-interest
    enabled: torch.Tensor        # [F, M] bool — density (live slots)


class SceneState(NamedTuple):
    """Struct-of-arrays object state; leaves lead with [F, M]."""
    pos: torch.Tensor            # [F, M, 2] degrees
    vel: torch.Tensor            # [F, M, 2] deg/s
    size: torch.Tensor           # [F, M, 2] degrees (w, h)
    waypoint: torch.Tensor       # [F, M, 2] person targets
    oid: torch.Tensor            # [F, M] int64 unique-per-camera ids
    next_id: torch.Tensor        # [F] int64


def kind_mask(spec: SceneSpec) -> np.ndarray:
    """[M] int — PERSON for the first max_people slots, CAR after."""
    return np.where(np.arange(spec.max_objects) < spec.max_people,
                    PERSON, CAR)


def scene_fleet_params(spec: SceneSpec, n_cameras: int, *, seed: int = 0,
                       scene_seeds=None, person_speed=1.2, car_speed=10.0,
                       churn=0.01, n_people=None, n_cars=None,
                       device=None) -> tuple[SceneFleetParams, torch.Tensor]:
    """Per-camera params + camera keys [F, 2]. Scalars broadcast; pass
    [F] arrays for heterogeneity. Camera f's key is
    fold_in(PRNGKey(seed), scene_seeds[f])."""
    f, m = n_cameras, spec.max_objects
    if scene_seeds is None:
        scene_seeds = np.arange(f)
    scene_seeds = np.broadcast_to(np.asarray(scene_seeds, np.int64), (f,))
    rng = prng.fold_in(prng.PRNGKey(seed, device),
                       torch.as_tensor(scene_seeds.copy(), device=device))

    def bc(x):
        return torch.as_tensor(
            np.broadcast_to(np.asarray(x, np.float32), (f,)).copy(),
            device=device)

    n_people = spec.max_people if n_people is None else n_people
    n_cars = spec.max_cars if n_cars is None else n_cars
    n_people = np.broadcast_to(np.asarray(n_people, np.int32), (f,))
    n_cars = np.broadcast_to(np.asarray(n_cars, np.int32), (f,))
    if (n_people > spec.max_people).any() or (n_cars > spec.max_cars).any():
        raise ValueError("per-camera n_people/n_cars exceed SceneSpec slots")
    idx = np.arange(m)
    enabled = np.where(idx[None, :] < spec.max_people,
                       idx[None, :] < n_people[:, None],
                       (idx[None, :] - spec.max_people) < n_cars[:, None])

    poi_keys = prng.fold_in(rng, _POI_SALT)
    lo = torch.tensor([15.0, 10.0], device=device)
    hi = torch.tensor([spec.extent[0] - 15.0, spec.extent[1] - 10.0],
                      device=device)
    poi = prng.uniform(poi_keys, (spec.n_poi, 2), lo, hi)
    params = SceneFleetParams(
        person_speed=bc(person_speed), car_speed=bc(car_speed),
        churn=bc(churn), poi=poi,
        enabled=torch.as_tensor(enabled, device=device))
    return params, rng


def fleet_from_config(cfg, n_cameras: int, *, seed: int = 0,
                      scene_seeds=None, device=None, **spec_overrides
                      ) -> tuple[SceneSpec, SceneFleetParams, torch.Tensor]:
    """Port one numpy `data.scene.SceneConfig`, geometry and dynamics, to
    the fleet substrate: (SceneSpec, homogeneous SceneFleetParams,
    camera keys [F, 2]), on `device` as scene_fleet_params."""
    spec = SceneSpec.from_config(cfg, **spec_overrides)
    params, rng = scene_fleet_params(
        spec, n_cameras, seed=seed, scene_seeds=scene_seeds,
        person_speed=cfg.person_speed, car_speed=cfg.car_speed,
        churn=cfg.churn, device=device)
    return spec, params, rng


def _norm(v: torch.Tensor, keepdim: bool = True) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def _gather_poi(poi: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """poi [F, n_poi, 2], idx [F, M] -> [F, M, 2]."""
    return torch.gather(poi, 1, idx[..., None].expand(-1, -1, 2))


def _spawn_draws(spec: SceneSpec, p: SceneFleetParams, key: torch.Tensor):
    """All per-slot respawn draws for the fleet -> dict of [F, M, ...]."""
    m = spec.max_objects
    dev = key.device
    ks = prng.split(key, 8)                          # [F, 8, 2]
    extent = torch.tensor(spec.extent, device=dev)
    ones = torch.tensor([1.0, 1.0], device=dev)
    # person draws
    poi_a = _gather_poi(p.poi, prng.randint(ks[:, 0], (m,), 0, spec.n_poi))
    pos_p = torch.clamp(poi_a + 8.0 * prng.normal(ks[:, 1], (m, 2)),
                        ones, extent - 1.0)
    wp_p = _gather_poi(p.poi, prng.randint(ks[:, 2], (m,), 0, spec.n_poi))
    speed_p = torch.clamp(
        p.person_speed[:, None] + 0.4 * prng.normal(ks[:, 3], (m,)),
        min=0.2)
    d = wp_p - pos_p
    vel_p = speed_p[..., None] * d / torch.clamp(_norm(d), min=1e-6)
    w_p = prng.uniform(ks[:, 4], (m,), spec.person_size[0],
                       spec.person_size[1])
    size_p = torch.stack([w_p * 0.45, w_p], -1)
    # car draws
    lanes = torch.tensor(spec.lane_tilts, device=dev)
    lane = lanes[prng.randint(ks[:, 5], (m,), 0, len(spec.lane_tilts))]
    u = prng.uniform(ks[:, 6], (m, 4))
    direction = torch.where(u[..., 0] < 0.5, -1.0, 1.0)
    x0 = torch.where(direction > 0, 0.0, float(spec.extent[0]))
    x0_init = u[..., 1] * spec.extent[0]        # initial placement
    tilt = lane + (u[..., 2] - 0.5) * 2.0 * 1.73
    speed_c = torch.clamp(
        p.car_speed[:, None] + 2.5 * prng.normal(ks[:, 7], (m,)), min=2.0)
    vel_c = torch.stack([direction * speed_c, torch.zeros_like(speed_c)],
                        -1)
    w_c = spec.car_size[0] + u[..., 3] * (spec.car_size[1]
                                          - spec.car_size[0])
    size_c = torch.stack([w_c, w_c * 0.45], -1)
    return dict(pos_p=pos_p, wp_p=wp_p, vel_p=vel_p, size_p=size_p,
                x0=x0, x0_init=x0_init, tilt=tilt, vel_c=vel_c,
                size_c=size_c)


def _person(spec: SceneSpec, device) -> torch.Tensor:
    return torch.as_tensor(kind_mask(spec) == PERSON, device=device)


def init_scene(spec: SceneSpec, params: SceneFleetParams,
               rng: torch.Tensor) -> SceneState:
    """Initial spawn for the whole fleet. rng [F, 2] camera keys."""
    f, m = rng.shape[0], spec.max_objects
    dev = rng.device
    person = _person(spec, dev)[None, :, None]
    d = _spawn_draws(spec, params, rng)
    pos = torch.where(person, d["pos_p"],
                      torch.stack([d["x0_init"], d["tilt"]], -1))
    vel = torch.where(person, d["vel_p"], d["vel_c"])
    size = torch.where(person, d["size_p"], d["size_c"])
    # disabled slots park far outside with zero size: never visible
    off = ~params.enabled[..., None]
    pos = torch.where(off, -1000.0, pos)
    vel = torch.where(off, 0.0, vel)
    size = torch.where(off, 0.0, size)
    return SceneState(
        pos=pos, vel=vel, size=size, waypoint=d["wp_p"],
        oid=torch.arange(m, device=dev).expand(f, m).clone(),
        next_id=torch.full((f,), m, dtype=torch.int64, device=dev))


def scene_step(spec: SceneSpec, params: SceneFleetParams,
               keys: torch.Tensor, s: SceneState) -> SceneState:
    """Advance every camera's scene one frame. keys [F, 2] per-step keys
    (fold_in(camera_key, frame_index))."""
    m = spec.max_objects
    dev = keys.device
    person1 = _person(spec, dev)                     # [M]
    person = person1[None, :, None]
    extent = torch.tensor(spec.extent, device=dev)
    dt = 1.0 / spec.fps
    sub = prng.split(keys, 4)
    k_wp, k_jit, k_churn, k_spawn = (sub[:, i] for i in range(4))

    pos = s.pos + s.vel * dt

    # people: retarget near waypoints, jitter heading, stay in bounds
    d = s.waypoint - pos
    arrived = _norm(d, keepdim=False) < 2.0
    kw = prng.split(k_wp)
    new_wp = (_gather_poi(params.poi,
                          prng.randint(kw[:, 0], (m,), 0, spec.n_poi))
              + 6.0 * prng.normal(kw[:, 1], (m, 2)))
    waypoint = torch.where((person1 & arrived)[..., None], new_wp,
                           s.waypoint)
    d = waypoint - pos
    speed = _norm(s.vel)
    v = (speed * d / torch.clamp(_norm(d), min=1e-6)
         + 0.3 * prng.normal(k_jit, (m, 2)))
    vel_pn = v / torch.clamp(_norm(v), min=1e-6) * speed
    pos_pn = torch.minimum(torch.clamp(pos, min=0.0), extent)
    vel = torch.where(person, vel_pn, s.vel)
    pos = torch.where(person, pos_pn, pos)

    # respawn: person churn + cars leaving the panorama
    churn = person1 & (prng.uniform(k_churn, (m,))
                       < (params.churn * dt * spec.fps)[:, None])
    out = ~person1 & ((pos[..., 0] < -3.0)
                      | (pos[..., 0] > spec.extent[0] + 3.0))
    respawn = (churn | out) & params.enabled

    sd = _spawn_draws(spec, params, k_spawn)
    sp_pos = torch.where(person, sd["pos_p"],
                         torch.stack([sd["x0"], sd["tilt"]], -1))
    sp_vel = torch.where(person, sd["vel_p"], sd["vel_c"])
    sp_size = torch.where(person, sd["size_p"], sd["size_c"])

    r = respawn[..., None]
    pos = torch.where(r, sp_pos, pos)
    vel = torch.where(r, sp_vel, vel)
    size = torch.where(r, sp_size, s.size)
    waypoint = torch.where(r, sd["wp_p"], waypoint)
    ri = respawn.to(torch.int64)
    new_ids = s.next_id[:, None] + torch.cumsum(ri, dim=1) - 1
    oid = torch.where(respawn, new_ids, s.oid)
    next_id = s.next_id + ri.sum(dim=1)
    return SceneState(pos=pos, vel=vel, size=size, waypoint=waypoint,
                      oid=oid, next_id=next_id)


def advance_scene(spec: SceneSpec, params: SceneFleetParams,
                  rng: torch.Tensor, state: SceneState, step_idx,
                  stride: int) -> SceneState:
    """Advance `stride` scene frames for controller step `step_idx` ([F]
    or scalar) — the scene runs at spec.fps, the controller at the
    response rate."""
    step_idx = torch.as_tensor(step_idx, dtype=torch.int64,
                               device=rng.device).expand(rng.shape[0])
    for j in range(stride):
        keys = prng.fold_in(rng, step_idx * stride + j)
        state = scene_step(spec, params, keys, state)
    return state
