"""chip_smoke.py's launcher phase (8h) alone, on the card: the dry runs
of stablelm-3b decode_32k and vit-b16 serve_b128 on the fake (16, 16)
mesh with fake tensors on the card, then build_cell's fn for vit-b16
serve_b128, dit-l2 gen_fast and vit-b16 cls_384 on a one-rank NCCL mesh
(numpy weights), each real run's FLOP count held equal to the dry
run's on a 1 x 1 mesh; every check as in the script. The phase runs in
a subprocess of its own (`chip_smoke.py --phase-8h`).

    python tools/launch_phase.py

Prints the "launch" lines, then one JSON line of the phase's numbers.
Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("launch_phase: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"card: {chip_smoke.card_line()}", flush=True)
    out = chip_smoke.launch_phase()
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
