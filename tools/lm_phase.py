"""chip_smoke.py's LM phase (8d) alone, on the card: stablelm-3b at
full width and depth (float32 checks, bf16 times), deepseek-v3 at full
width cut to 4 layers, the flash kernel at both models' shapes and the
SMOKE configs card vs CPU, after the kernel build; every check as in
the script.

    python tools/lm_phase.py

Prints the "lm" lines, then one JSON line of the phase's launches,
times and comparisons. Needs a CUDA card (~45 s with the build).
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
        print("lm_phase: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}", flush=True)
    chip_smoke._lib.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = chip_smoke.lm_phase(torch.device("cuda"))
    out["rows"] = {k: {kk: vv for kk, vv in v.items() if kk != "bound"}
                   for k, v in out["rows"].items()}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
