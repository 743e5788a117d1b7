"""Fleet experiments through the unified API: one declarative spec.

    python -m repro_torch.examples.fleet_experiment [--device cpu]

Describes a heterogeneous camera fleet as a `FleetRunSpec` — provider
name + kwargs, workload, budget, episode length, seed — and runs it with
`run_fleet`: per-camera scenes and network traces generated on the
device, typed `FleetResult` out. The spec round-trips through JSON, so
experiment definitions can live in files or job queues; swap
provider="scene" for "detector" to put the approximation network in the
loop, or "tables" to replay the host-built substrate.

Set REPRO_EX_CAMERAS / REPRO_EX_STEPS to shrink the episode.
"""
import argparse
import os

import numpy as np

from repro_torch.fleet import FleetRunSpec, run_fleet


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    f = int(os.environ.get("REPRO_EX_CAMERAS", "8"))
    steps = int(os.environ.get("REPRO_EX_STEPS", "24"))
    rng = np.random.default_rng(0)

    spec = FleetRunSpec(
        provider="scene", n_cameras=f, n_steps=steps, seed=0,
        budget={"fps": 3.0},
        provider_kwargs={
            "scene_seeds": np.arange(f),            # world per camera
            "person_speed": rng.uniform(0.8, 2.0, f),
            "n_people": rng.integers(4, 15, f),
            "mbps": np.full(f, 24.0), "net_seed": 0,  # mobile links
        })
    # specs are data: ship them through JSON and back before running
    spec = FleetRunSpec.from_json(spec.to_json())

    res = run_fleet(spec, device=args.device)
    print(f"providers available via the same entry: tables, scene, "
          f"detector (spec.provider={spec.provider!r})")
    print(f"fleet accuracy {res.accuracy:.3f} over {res.n_steps} steps "
          f"x {res.n_cameras} cameras "
          f"(mean shape {res.mean_shape:.1f}, "
          f"{sum(res.frames_sent)} frames shipped, "
          f"{res.camera_steps_per_s:.0f} camera-steps/s after warm-up, "
          f"{args.device})")
    print(f"result JSON: {len(res.to_json())} bytes "
          f"(per-step accuracies, chosen orientations, frames, timings)")


if __name__ == "__main__":
    main()
