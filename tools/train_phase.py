"""chip_smoke.py's training phase (8f) alone, on the card: stablelm-3b
at full width and depth in bf16 with remat and AdamW (3 steps at 8 x
2048 tokens in 4 microbatches), its float32 remat and microbatch checks
at depth 2, ViT-B/16 with Adafactor at batch 128, `python -m
repro_torch.launch.train` resumed from its own checkpoint, and one step
of every SMOKE config card vs CPU; every check as in the script. The
train path launches no kernel, so nothing is built.

    python tools/train_phase.py

Prints the "train" lines, then one JSON line of the phase's numbers.
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
        print("train_phase: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = chip_smoke.train_phase(torch.device("cuda"))
    out["seconds"] = time.perf_counter() - t0
    out["launcher"] = {str(k): v for k, v in out["launcher"].items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
