"""Time the main path's episode — run_fleet(provider="detector") at full
madeye-approx width, 64 cameras, 8 steps (+1 warm-up), shortlist_k=18 —
for the repro_torch package found under --src, frozen or with in-episode
distillation, so two versions (say a commit and its parent, unpacked
side by side) are timed alike in one run on one card.

    python tools/time_episode.py [--src DIR] [--distill off|head|full]
                                 [--reps 2]

DIR holds the `repro_torch` package (default: this checkout's src);
`--distill head` is DistillSpec() (head-only AdamW, the paper's mode)
and `full` DistillSpec(head_only=False), both with MetricsSpec() on.
Each rep is one run_fleet call (kernels built and loaded at the first).
Prints the card's `nvidia-smi` name and power limit, then one JSON line:
steady_s and camera_steps_per_s per rep (host clock around the episode,
which ends in a synchronise), the accuracy, and the peak device memory.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--distill", choices=("off", "head", "full"),
                    default="off")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, args.src)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.fleet.api import FleetRunSpec, run_fleet

    if not torch.cuda.is_available():
        print("time_episode: no CUDA device is available", file=sys.stderr)
        return 1
    extra = {}
    if args.distill != "off":
        extra = dict(distill={"head_only": args.distill == "head"},
                     metrics=True)
    spec = FleetRunSpec(
        provider="detector", n_cameras=64, n_steps=8, shortlist_k=18,
        provider_kwargs={"det_cfg": get_config("madeye-approx")}, **extra)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    steady, rate = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(args.reps):
        res = run_fleet(spec)
        steady.append(res.timings["steady_s"])
        rate.append(res.camera_steps_per_s)
    print(f"card: {card}", flush=True)
    print(json.dumps({
        "src": args.src, "distill": args.distill, "steady_s": steady,
        "camera_steps_per_s": rate, "accuracy": res.accuracy,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
