"""Serving launcher — the MadEye camera-fleet loop, end to end, with the
fleet on the CUDA card.

Runs the full adaptive-orientation pipeline on the procedural scene:
controller plans -> camera sweeps -> approximation proxies score -> top-k
ship -> accuracy vs the oracle baselines (the single camera and the
baselines are numpy on the host). `--fleet N` additionally runs an
N-camera fleet through repro_torch.fleet.run_fleet with the observation
provider picked by `--provider`:

  tables    host-built teacher tables, one shared world (default)
  scene     per-camera heterogeneous scenes + per-camera network traces,
            observations generated inside the episode on the device
  detector  scene + the approximation detector in the loop: candidate
            crops rendered and scored by the network inside the episode

`--telemetry PATH|-` streams each fleet run as JSON-lines telemetry
events (repro_torch.obs.events: run_start / steps chunks with per-camera
health / run_end) to a file or stdout, with the in-episode FleetMetrics
enabled on the run so events carry EWMA labels, shortlist hit-rates,
and chosen-rank medians.

`--distill` (detector fleets) turns on in-episode continual distillation
(repro_torch.learn): each camera's approximation heads train against the
scene teachers inside the episode.

`--device` picks where the fleet runs: `cuda` (the default; raises
without a card) or `cpu` (the kernels' plain versions).

  PYTHONPATH=src python -m repro_torch.launch.serve --fps 5 --duration 20
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 4 --telemetry -
  PYTHONPATH=src python -m repro_torch.launch.serve --fleet 2 \
      --provider detector --shortlist-k 18 --distill
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --fps 2 --duration 3 --fleet 4
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core import DEFAULT_GRID, Query, Workload
from repro_torch.core.grid import OrientationGrid
from repro_torch.core.tradeoff import BudgetConfig
from repro_torch.data import SceneConfig, build_video
from repro_torch.fleet.api import DEFAULT_QUERIES, FleetRunSpec, run_fleet
from repro_torch.fleet.runner import resolve_device
from repro_torch.obs.events import episode_events, write_events
from repro_torch.serving import (
    NetworkTrace,
    detection_tables,
    run_madeye,
    run_scheme,
    workload_acc_table,
)

DEFAULT_WORKLOAD = Workload(tuple(Query(*q) for q in DEFAULT_QUERIES))

PROVIDERS = ("tables", "scene", "detector")


def _fleet_spec(provider: str, n: int, *, n_steps, seed, mbps, rtt_ms,
                grid, workload, budget, substrate, shortlist_k=None,
                distill=None):
    """The FleetRunSpec serve runs for `--fleet n --provider name` —
    scene/detector fleets get per-camera heterogeneity (world seeds,
    densities, speeds, mobile network traces); the tables fleet reuses
    the already-built host substrate. `shortlist_k` (detector provider)
    caps the candidate windows scored per camera-step; `distill`
    (detector provider) turns on in-episode continual distillation of
    the per-camera approximation heads."""
    if provider == "tables":
        video, tables, acc, trace = substrate
        return FleetRunSpec.from_objects(
            "tables", n_cameras=n, n_steps=None, seed=seed, grid=grid,
            workload=workload, budget=budget, video=video, tables=tables,
            trace=trace, acc_table=acc)
    rng = np.random.default_rng(seed)
    kwargs = dict(
        scene_seeds=np.arange(n),
        person_speed=rng.uniform(0.8, 2.0, n),
        car_speed=rng.uniform(6.0, 14.0, n),
        n_people=rng.integers(4, 15, n), n_cars=rng.integers(2, 9, n))
    if provider == "scene":
        kwargs.update(mbps=np.full(n, mbps), rtt_ms=rtt_ms, net_seed=seed)
    return FleetRunSpec.from_objects(
        provider, n_cameras=n, n_steps=n_steps, seed=seed, grid=grid,
        workload=workload, budget=budget,
        shortlist_k=shortlist_k if provider == "detector" else None,
        distill=distill if provider == "detector" else None,
        **kwargs)


def serve(fps: float, duration: float, *, seed: int = 3,
          mbps: float = 24.0, rtt_ms: float = 20.0,
          rotation_speed: float = 400.0, pipelined: bool = False,
          fleet: int = 0, provider: str = "tables",
          fleet_scene: int = 0, fleet_detector: int = 0,
          shortlist_k: int | None = None, distill: bool = False,
          telemetry: str | None = None,
          grid: OrientationGrid = DEFAULT_GRID,
          workload: Workload = DEFAULT_WORKLOAD, device="cuda"):
    """Run the launcher; `device` is where the fleet runs ("cuda", the
    default, raises without a card; "cpu" runs the plain versions).
    Returns the single-camera MadEye RunResult."""
    for name, val in (("--fleet", fleet), ("--fleet-scene", fleet_scene),
                      ("--fleet-detector", fleet_detector)):
        if val < 0:
            raise SystemExit(f"{name} must be >= 0, got {val}")
    if provider not in PROVIDERS:
        raise SystemExit(f"--provider must be one of {PROVIDERS}, "
                         f"got {provider!r}")
    # fold the deprecated aliases into (n_cameras, provider) runs
    runs = [(fleet, provider)] if fleet else []
    for n, name, flag in ((fleet_scene, "scene", "--fleet-scene"),
                          (fleet_detector, "detector", "--fleet-detector")):
        if n:
            print(f"note: {flag} N is deprecated; "
                  f"use --fleet N --provider {name}")
            runs.append((n, name))
    if shortlist_k is not None and not any(p == "detector"
                                           for _, p in runs):
        raise SystemExit(
            "--shortlist-k only applies to a detector fleet "
            "(--fleet N --provider detector); no other provider scores "
            "a per-window model, and dropping the flag silently would "
            "make a shortlist sweep meaningless")
    if distill and not any(p == "detector" for _, p in runs):
        raise SystemExit(
            "--distill only applies to a detector fleet "
            "(--fleet N --provider detector); no other provider carries "
            "a per-camera model to train, and dropping the flag "
            "silently would report frozen results as a learning run")
    device = resolve_device(device)

    t0 = time.time()
    video = build_video(grid, SceneConfig(fps=15, seed=seed), duration)
    tables = detection_tables(video, workload)
    acc = workload_acc_table(video, workload, tables)
    trace = NetworkTrace.fixed(mbps, rtt_ms, video.n_frames)
    budget = BudgetConfig(fps=fps, rotation_speed=rotation_speed,
                          pipelined=pipelined)
    print(f"substrate built in {time.time()-t0:.1f}s "
          f"({video.n_frames} frames x {grid.n_cells} cells)")

    res = run_madeye(video, workload, tables, budget, trace, acc_table=acc)
    print(f"MadEye      : acc={res.accuracy:.3f} shape={res.mean_shape:.1f} "
          f"sent/step={res.frames_sent/len(res.visited):.1f} "
          f"best-explored={res.best_explored_rate:.2f}")

    n_steps = max(1, int(duration * fps))
    for n, name in runs:
        spec = _fleet_spec(name, n, n_steps=n_steps, seed=seed, mbps=mbps,
                           rtt_ms=rtt_ms, grid=grid, workload=workload,
                           budget=budget,
                           substrate=(video, tables, acc, trace),
                           shortlist_k=shortlist_k,
                           distill=distill if name == "detector" else None)
        if telemetry is not None:
            # telemetry events enrich from the in-episode FleetMetrics
            spec = dataclasses.replace(spec, metrics=True)
        r = run_fleet(spec, device=device)
        wall = r.timings["build_s"] + r.timings["episode_s"]
        print(f"fleet x{n:<4d} [{name}]: acc={r.accuracy:.3f} "
              f"mean shape {r.mean_shape:.1f}, "
              f"sent/step={sum(r.frames_sent)/(r.n_steps*n):.1f}, "
              f"{r.n_steps} steps in {wall:.2f}s end-to-end incl. the "
              f"warm-up step ({r.camera_steps_per_s:.0f} steady "
              f"camera-steps/s)")
        if r.distill_loss is not None:
            upd = [v for v in r.distill_loss if v >= 0]
            print(f"  distill: {len(upd)} update steps, loss "
                  f"{upd[0]:.4f} -> {upd[-1]:.4f}" if upd else
                  "  distill: no update steps (ring never filled)")
        if telemetry is not None:
            n_ev = write_events(episode_events(r), telemetry)
            if telemetry != "-":
                print(f"  telemetry: {n_ev} events -> {telemetry}")

    for scheme in ("one_time_fixed", "best_fixed", "best_dynamic",
                   "panoptes", "tracking", "ucb1"):
        r = run_scheme(video, workload, tables, scheme, budget=budget,
                       acc_table=acc)
        print(f"{scheme:12s}: acc={r.accuracy:.3f}")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fps", type=float, default=5.0)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--mbps", type=float, default=24.0)
    ap.add_argument("--rtt-ms", type=float, default=20.0)
    ap.add_argument("--rotation-speed", type=float, default=400.0)
    ap.add_argument("--pipelined", action="store_true")
    ap.add_argument("--fleet", type=int, default=0,
                    help="also run the fleet API "
                         "(repro_torch.fleet.run_fleet) with this many "
                         "cameras")
    ap.add_argument("--provider", choices=PROVIDERS, default="tables",
                    help="observation provider for --fleet: host tables, "
                         "device-resident scenes, or the detector network "
                         "scoring rendered crops in the episode")
    ap.add_argument("--shortlist-k", type=int, default=None,
                    help="detector provider: candidate windows rendered"
                         " + scored per camera-step (multiple of the "
                         "zoom count; default all = exhaustive)")
    ap.add_argument("--distill", action="store_true",
                    help="detector provider: continually distill each "
                         "camera's approximation heads from the scene "
                         "teachers inside the episode "
                         "(repro_torch.learn, paper §3.4 defaults)")
    ap.add_argument("--telemetry", type=str, default=None,
                    metavar="PATH|-",
                    help="stream each fleet run as JSONL telemetry "
                         "events (repro_torch.obs.events schema) to a "
                         "file (append) or stdout (-); enables the "
                         "in-episode FleetMetrics on the run")
    ap.add_argument("--fleet-scene", type=int, default=0,
                    help="[deprecated] alias for "
                         "`--fleet N --provider scene`")
    ap.add_argument("--fleet-detector", type=int, default=0,
                    help="[deprecated] alias for "
                         "`--fleet N --provider detector`")
    ap.add_argument("--device", type=str, default="cuda",
                    help="where the fleet runs: cuda (raises without a "
                         "card) or cpu (the kernels' plain versions)")
    args = ap.parse_args()
    serve(args.fps, args.duration, seed=args.seed, mbps=args.mbps,
          rtt_ms=args.rtt_ms, rotation_speed=args.rotation_speed,
          pipelined=args.pipelined, fleet=args.fleet,
          provider=args.provider, fleet_scene=args.fleet_scene,
          fleet_detector=args.fleet_detector,
          shortlist_k=args.shortlist_k, distill=args.distill,
          telemetry=args.telemetry, device=args.device)


if __name__ == "__main__":
    main()
