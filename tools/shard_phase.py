"""chip_smoke.py's sharding phase (8g) alone, on the card: the main
path's cell unsharded (phase 5's run, the reference of this phase), then
the same fleet with ShardSpec("debug") on a one-rank NCCL mesh and split
over two processes sharing the card (gloo), stablelm-3b's 32 layers
through make_pipelined_forward (bf16, flash), the collectives at
stablelm-3b's decode shape, stablelm-3b's parameters laid out, saved,
restored and laid out again, and crosspod_allreduce_compressed over
ViT-B/16's gradients; every check as in the script.

    python tools/shard_phase.py

Prints the "shard" lines, then one JSON line of the phase's numbers.
Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("shard_phase: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    chip_smoke._lib.library()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    spec = chip_smoke.FleetRunSpec(
        provider="detector", n_cameras=chip_smoke.N_CAMERAS,
        n_steps=chip_smoke.N_STEPS, shortlist_k=chip_smoke.SHORTLIST_K,
        provider_kwargs={"det_cfg": chip_smoke.get_config("madeye-approx")})
    whole = chip_smoke._fleet_summary(chip_smoke.run_fleet(spec))
    print(f"main path (unsharded): accuracy={whole['accuracy']:.6f} "
          f"steady_s={whole['steady_s']:.3f}", flush=True)
    t0 = time.perf_counter()
    out = chip_smoke.shard_phase(dev, spec, whole)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
