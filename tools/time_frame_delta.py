"""Time the frame_delta kernel on one 1080p frame, per call and by CUDA-graph
replay, for the repro_torch package found under --src, so two versions of
csrc/frame_delta.cu (say a commit and its parent, unpacked side by side)
are timed alike in one run on one card.

    python tools/time_frame_delta.py [--src DIR] [--reps 3]

DIR holds the `repro_torch` package (default: this checkout's src); its
kernels are built from DIR's sources at first use. Frames and timing are
tools/kernel_table.py's: 16 x 128 tiles moving by N(0, sigma) noise with sigma
0.002, 0.025 or 0.05, `ms` the mean of 100 back-to-back calls by CUDA
events (the wrapper's host dispatch included), `graph_ms` one CUDA graph
of 100 calls replayed (device time per call). Prints the card's
`nvidia-smi` name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

FRAME = (1080, 1920, 3)
ITERS = 100


def frames(dev, seed: int = 5):
    h, w, c = FRAME
    gen = torch.Generator(device=dev).manual_seed(seed)
    prev = torch.rand((h, w, c), generator=gen, device=dev)
    sig = torch.tensor([0.002, 0.025, 0.05], device=dev)[torch.randint(
        0, 3, (-(-h // 16), -(-w // 128)), generator=gen, device=dev)]
    sig = sig.repeat_interleave(16, 0)[:h].repeat_interleave(128, 1)[:, :w]
    cur = prev + sig[..., None] * torch.randn((h, w, c), generator=gen,
                                              device=dev)
    return cur, prev


def per_call_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def graph_ms(fn) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.frame_delta.ops import (  # noqa: E402
        frame_delta_plain,
        frame_delta_tiles,
    )
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cur, prev = frames(torch.device("cuda"))
    dq, changed = frame_delta_tiles(cur, prev)
    dq_p, changed_p = frame_delta_plain(cur, prev)
    agree = changed == changed_p
    px = agree.repeat_interleave(16, 0)[:FRAME[0]].repeat_interleave(
        128, 1)[:, :FRAME[1]]
    same_q = bool(((dq == dq_p) | ~px[..., None]).all())

    def call():
        frame_delta_tiles(cur, prev)

    ms = [per_call_ms(call) for _ in range(args.reps)]
    gms = [graph_ms(call) for _ in range(args.reps)]
    print(f"card: {card}")
    print(json.dumps({"src": args.src, "frame": FRAME, "ms": ms,
                      "graph_ms": gms,
                      "tiles_flipped": int((~agree).sum()),
                      "int8_equal_on_agreeing_tiles": same_q}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
