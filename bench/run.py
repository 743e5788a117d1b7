"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 bench/run.py --workload approx-f64-k18 --seed 7 --seconds 35 \\
        --trace 0

Finds the cell in BENCHMARK.json, its configuration, the model module
the configuration names (bench/models/<model>.py), its traffic mix and
limits under bench/, makes the model's weights on the card from the
seed, prepares the port's fleet (repro_torch.fleet.api), warms it up,
runs the timed window, with --trace 1 a profiled stretch after it, then
holds sampled steps against the plain reference (bench/reference). The
last line of standard output is the result as one JSON object; the
comparison's numbers and limits are the last lines of standard error.
Exits non-zero, printing no result, without enough CUDA cards, or when
jax, jaxlib, flax or the JAX package is loaded at the end.

The process keeps to one CPU core and one intra-op thread: the step is
bound by the host's dispatch, and a process that moves between cores
reads a wider spread of step rates on a shared host.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The top-level names among `names` (the loaded modules by default)
    that are one of FORBIDDEN, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def pin_to_one_core() -> None:
    """Keep this process (and what it starts) on one of its allowed
    cores, with one OpenMP thread."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[max(0, len(cores) // 2 - 1)]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    pin_to_one_core()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    cache = ROOT / "build" / "cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    from bench.harness.cell import load_cell
    from bench.harness.runner import run_cell

    cell = load_cell(a.workload, ROOT)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"{a.workload} needs {cell.chips} CUDA card(s); found "
              f"{found}", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, a.seed, a.seconds, bool(a.trace),
                             "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
