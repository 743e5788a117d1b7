"""The readings the comparison's limits are set from: one process runs a
cell on many seeds, each a short window at the cell's own size, and
prints per seed the program's numbers and the lower-precision
control's (the reference with TF32-rounded products in the program's
place), one JSON line each.

    python3 bench/calibrate.py --workload approx-f64-k18 \\
        --seeds 11,12,13 --seconds 4

Needs a CUDA card, as bench/run.py does. The benchmark's own runs do not
run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=4.0)
    a = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench.harness.cell import load_cell
    from bench.harness.runner import run_cell

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(a.workload, ROOT)
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        res, _ = run_cell(cell, seed, a.seconds, False, "cuda", t0,
                          control=True)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "steps": res["attempted"],
                          "numbers": res["numbers"],
                          "device": res["device"]["kind"]}), flush=True)
        torch.cuda.empty_cache()
    print(f"calibrate: {time.perf_counter() - T_START:.1f} s",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
