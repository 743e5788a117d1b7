"""chip_smoke.py's zoo phase (8e) alone, on the card: ViT-H/14, ViT-B/16
and ViT-S/16 at full width and depth (float32 flash vs xla, bf16 times
at batch 128), the flash kernel at ViT-H/14's and ViT-B/16's shapes,
Swin-B (224 and 384 px), DiT-L/2 and Flux-dev sampled at gen_fast, one
full-width block of each family and the six SMOKE configs card vs CPU,
after the kernel build; every check as in the script.

    python tools/zoo_phase.py

Prints the "zoo" lines, then one JSON line of the phase's launches,
times and comparisons. Needs a CUDA card.
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
        print("zoo_phase: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}", flush=True)
    chip_smoke._lib.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = chip_smoke.zoo_phase(torch.device("cuda"))
    out["rows"] = chip_smoke._row_json(out["rows"])
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
