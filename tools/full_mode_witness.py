"""Hold full-mode distillation at full madeye-approx width against the
JAX package: run_fleet(provider="detector", distill={"head_only":
False}, metrics=True) with 2 cameras, 3 steps and shortlist_k=18, on a
scene of 40 object slots (max_people=24, max_cars=16: the reference's
top_k needs at least the config's 32 boxes per crop), from one set of
seeded weights. Each package runs in a process of its own, so no
process imports both.

    python tools/full_mode_witness.py [--device cpu|cuda] [--steps 3]
                                      [--out DIR] [--against FILE]
                                      [--weights NPZ]

runs the port on --device and writes DIR/torch_<device>.json; with
--device cpu it also runs the JAX package on the CPU (DIR/jax.json).
The weights are the port's detector_init from --seed, written to
DIR/weights.npz, or the .npz given by --weights (pass the file an
earlier run wrote when comparing against that run on another machine:
another PyTorch version may draw other values from the same seed).
It prints each side's per-step loss (the fleet mean, as
FleetResult.distill_loss) and per-camera losses, then compares the port
with the JAX run (or with the run saved in FILE): decisions equal, and
the largest relative difference of the per-camera loss on each step.
Exits 1 if the decisions differ.

    python tools/full_mode_witness.py --side torch|jax --out DIR [...]

runs one side only (the worker the first form starts).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DECISIONS = ("chosen", "explored", "order", "zooms", "sent")


def _spec_kw(steps: int, weights: str) -> dict:
    return dict(provider="detector", n_cameras=2, n_steps=steps, seed=2,
                shortlist_k=18, distill={"head_only": False}, metrics=True,
                provider_kwargs={"det_params": weights})


def run_torch(args) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.fleet.api import FleetRunSpec, run_fleet
    from repro_torch.fleet.runner import save_detector_params
    from repro_torch.models.detector import detector_init
    from repro_torch.scene.scene import SceneSpec

    cfg = get_config("madeye-approx")
    weights = str(Path(args.out) / "weights.npz")
    if args.weights:
        weights = args.weights
    else:
        save_detector_params(weights, detector_init(
            torch.Generator().manual_seed(args.seed), cfg))
    kw = _spec_kw(args.steps, weights)
    kw["provider_kwargs"].update(
        det_cfg=cfg, spec=SceneSpec(max_people=24, max_cars=16))
    res = run_fleet(FleetRunSpec(**kw), device=args.device)
    return dict(
        side=f"torch_{args.device}", weights=_fingerprint(weights),
        distill_loss=list(res.distill_loss),
        camera_loss=res.metrics["distill_loss"].cpu().numpy().tolist(),
        acc_per_step=list(res.acc_per_step),
        **{k: getattr(res.out, k).cpu().numpy().astype(int).tolist()
           for k in DECISIONS})


def run_jax(args) -> dict:
    import numpy as np

    from repro.configs import get_config
    from repro.fleet.api import FleetRunSpec, run_fleet
    from repro.scene_jax.scene import SceneSpec

    weights = args.weights or str(Path(args.out) / "weights.npz")
    kw = _spec_kw(args.steps, weights)
    kw["provider_kwargs"].update(
        det_cfg=get_config("madeye-approx"),
        spec=SceneSpec(max_people=24, max_cars=16))
    res = run_fleet(FleetRunSpec(**kw))
    return dict(
        side="jax", weights=_fingerprint(weights),
        distill_loss=list(res.distill_loss),
        camera_loss=np.asarray(res.metrics["distill_loss"]).tolist(),
        acc_per_step=list(res.acc_per_step),
        **{k: np.asarray(getattr(res.out, k)).astype(int).tolist()
           for k in DECISIONS})


def _fingerprint(path: str) -> str:
    """SHA-256 of every weight's bytes, in sorted key order."""
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    with np.load(path) as z:
        for k in sorted(z.files):
            h.update(k.encode())
            h.update(np.ascontiguousarray(z[k], dtype=np.float32).tobytes())
    return h.hexdigest()[:16]


def _side(side: str, args) -> dict:
    cmd = [sys.executable, __file__, "--side", side, "--out", args.out,
           "--steps", str(args.steps), "--seed", str(args.seed),
           "--device", args.device]
    if side == "torch" and args.weights:
        cmd += ["--weights", args.weights]
    if side == "jax":
        cmd += ["--weights",
                args.weights or str(Path(args.out) / "weights.npz")]
    subprocess.run(cmd, check=True, timeout=3000,
                   env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    name = "jax" if side == "jax" else f"torch_{args.device}"
    return json.loads((Path(args.out) / f"{name}.json").read_text())


def compare(got: dict, want: dict) -> bool:
    import numpy as np

    same = all(got[k] == want[k] for k in DECISIONS)
    print(f"{got['side']} vs {want['side']}: weights "
          f"{'equal' if got['weights'] == want['weights'] else 'DIFFER'} "
          f"(sha256 {got['weights']} / {want['weights']}), "
          f"decisions {'equal' if same else 'DIFFER'}")
    g, w = np.array(got["camera_loss"]), np.array(want["camera_loss"])
    for e in range(len(w)):
        rel = np.abs(g[e] - w[e]) / np.maximum(np.abs(w[e]), 1e-30)
        print(f"  step {e}: camera loss {g[e].tolist()} vs {w[e].tolist()}"
              f" max rel diff {float(rel.max()):.3e}")
    return same


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", choices=("torch", "jax"))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "witness"))
    ap.add_argument("--against")
    ap.add_argument("--weights")
    args = ap.parse_args()
    Path(args.out).mkdir(parents=True, exist_ok=True)

    if args.side:
        res = run_torch(args) if args.side == "torch" else run_jax(args)
        (Path(args.out) / f"{res['side']}.json").write_text(json.dumps(res))
        return 0

    if args.device != "cpu":
        print("card: " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0])
    got = _side("torch", args)
    if args.against:
        want = json.loads(Path(args.against).read_text())
    elif args.device == "cpu":
        want = _side("jax", args)
    else:
        want = None
    for r in (got, want):
        if r is not None:
            print(f"{r['side']}: distill_loss {r['distill_loss']}")
    return 0 if want is None or compare(got, want) else 1


if __name__ == "__main__":
    sys.exit(main())
