"""Time schedules of the box_iou kernel side by side on one card.

    python3 tools/box_iou_schedules.py [--n 9216]

Builds variants of src/repro_torch/csrc/box_iou.cu that differ only in
their schedule constants — rows of A per slab (kRows), waves of
resident blocks (kWaves; 0 launches one block per slab) — and one
without the skipped division, each with nvcc into its own library under
build/box_iou_schedules/ (one nvcc per variant, started together). Each
variant must be bit-equal to box_iou_plain; each is timed by CUDA events
over 50 back-to-back launches on N x N random boxes (~10% of pairs
intersect) and on dense boxes (~80%), beside a write-only pass over the
same output (Tensor.zero_) and the bound (the output's bytes at 3.35
TB/s). Prints the card's nvidia-smi name and power limit, then one JSON
line. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "csrc" / "box_iou.cu"
OUT = ROOT / "build" / "box_iou_schedules"
NVCC = ("/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false",
        "-shared")
ROWS = "constexpr int kRows = 16;"
WAVES = "constexpr int kWaves = 4;"
GRID = "const int fit = max(1, kWaves * sms * max(per_sm, 1) / col_blocks);"
SKIP = """        v[j] = inter;
        if (inter != 0.0f) {
          v[j] = inter / fmaxf(area_a + area_b[j] - inter, 1e-9f);
        }"""
# name -> (rows per slab, waves (0: one block per slab), skip division)
VARIANTS = {"rows16_waves4": (16, 4, True), "rows16_waves1": (16, 1, True),
            "rows16_waves2": (16, 2, True), "rows16_per_slab": (16, 0, True),
            "rows8_waves4": (8, 4, True), "rows32_waves4": (32, 4, True),
            "rows16_waves4_no_skip": (16, 4, False)}


def variant_source(rows: int, waves: int, skip: bool) -> str:
    src = SRC.read_text()
    for old in (ROWS, WAVES, GRID, SKIP):
        if old not in src:
            raise RuntimeError(f"box_iou.cu no longer holds {old!r}")
    src = src.replace(ROWS, f"constexpr int kRows = {rows};")
    src = src.replace(WAVES, f"constexpr int kWaves = {max(waves, 1)};")
    if waves == 0:
        src = src.replace(GRID, "const int fit = n_slabs;")
    if not skip:
        src = src.replace(SKIP, "        v[j] = inter / fmaxf(area_a + "
                          "area_b[j] - inter, 1e-9f);")
    return src.replace('#include "common.cuh"',
                       f'#include "{SRC.parent / "common.cuh"}"')


def build(name: str) -> Path:
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(variant_source(*VARIANTS[name]))
    subprocess.run([*NVCC, "-o", str(so), str(cu)], check=True)
    return so


def cuda_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=9216)
    n = parser.parse_args().n
    if not torch.cuda.is_available():
        print("box_iou_schedules: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.box_iou.ops import box_iou_plain
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def boxes(lo, span, size_lo, size_span):
        return torch.cat([lo + span * torch.rand((n, 2), generator=gen,
                                                 device=dev),
                          size_lo + size_span * torch.rand(
                              (n, 2), generator=gen, device=dev)], 1)

    inputs = {"random": (boxes(0.0, 1.0, 0.02, 0.3),
                         boxes(0.0, 1.0, 0.02, 0.3)),
              "dense": (boxes(0.3, 0.4, 0.1, 0.4), boxes(0.3, 0.4, 0.1, 0.4))}
    out = torch.empty((n, n), device=dev)
    result = {"card": card, "n": n,
              "bound_ms": 4.0 * (8 * n + n * n) / 3.35e12 * 1e3}
    stream = torch.cuda.current_stream().cuda_stream
    for label, (a, b) in inputs.items():
        want = box_iou_plain(a, b)
        row = {"intersect": float((want > 0).float().mean()),
               "zero_ms": cuda_ms(out.zero_)}
        for name, path in libs.items():
            fn = getattr(ctypes.CDLL(str(path)), "box_iou_launch")
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call(fn=fn):
                if fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, n,
                      stream):
                    raise RuntimeError(f"{name}: launch refused")

            call()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"{name} ({label}): not bit-equal")
            row[name] = cuda_ms(call)
        result[label] = row
        print(f"{label}: " + " ".join(
            f"{k}={v:.4f}" for k, v in row.items()), flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
