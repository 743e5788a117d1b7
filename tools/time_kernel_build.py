"""Time a fresh build of the port's CUDA kernels two ways:

  parallel  what repro_torch.kernels._lib.build() does: one nvcc process
            per source, all started together, then one link;
  single    one nvcc call that compiles and links every source.

    python3 tools/time_kernel_build.py

Needs nvcc (no card). Each build goes into a fresh directory under
build/ that is deleted afterwards; prints one line per build and the
host's CPU count, since nvcc's time is host time.
"""
from __future__ import annotations

import os
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _lib  # noqa: E402


def parallel(out_dir: Path) -> Path:
    _lib.BUILD_DIR = out_dir
    return _lib.build()


def single(out_dir: Path) -> Path:
    out_dir.mkdir(parents=True)
    out = out_dir / "librepro_torch_single.so"
    _lib._run_all([[_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o",
                    str(out), *(str(_lib.CSRC / s) for s in _lib.SOURCES)]])
    return out


def main() -> int:
    print(f"host cpus: {os.cpu_count()}, sources: {len(_lib.SOURCES)}",
          flush=True)
    for name, fn in (("parallel", parallel), ("single", single)):
        out_dir = ROOT / "build" / f"time_build_{name}"
        shutil.rmtree(out_dir, ignore_errors=True)
        t0 = time.perf_counter()
        lib = fn(out_dir)
        dt = time.perf_counter() - t0
        print(f"build {name}: {dt:.1f} s ({lib.stat().st_size} bytes)",
              flush=True)
        shutil.rmtree(out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
