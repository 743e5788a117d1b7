"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (every one must pass; the exit code is non-zero otherwise):

  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from src/repro_torch/csrc with nvcc (one
     process per source, all started together) and count each kernel's
     tensor-core instructions (HGMMA/HMMA) in the library's SASS;
  3. hold each kernel against its plain PyTorch version on the card —
     neighbor_score (the kernel API the shape search used to launch),
     cell_rasterize (the kernel API the oracle pass used to launch) and
     crop_patchify at the main path's shapes, then
     flash_attention (the ViT's layer, stablelm-3b's causal width, GQA
     with q_offset, bf16, and 192- and 256-wide heads), box_iou (bit-equal),
     frame_delta and rmsnorm at full-size shapes — and time each with
     CUDA events beside its bound and, where one PyTorch call computes
     the same function, that call; kernels whose device time is near or
     below a Python call's dispatch time also get a device-only time (a
     CUDA graph of the calls, replayed);
  4. check the port end to end on a small input: run_fleet on the card
     and on the CPU (plain versions) must make the same decisions;
  5. drive the main path once — run_fleet(provider="detector") at the
     full width of madeye-approx, 64 cameras, 8 steps, shortlist_k=18 —
     with the launch counters set to 0 just before and read just after;
     each of the four main-path kernels (shape_search, budget_walk,
     oracle_pass, crop_patchify) must have launched once per step, and
     no other (run_fleet runs the reference's plain attention, the shape
     search scores its candidates inside shape_search and the oracle
     pass rasterizes inside oracle_pass); the result must be well
     formed. The inputs and outputs of every oracle_pass, shape_search
     and budget_walk call of the episode are recorded, and the plain
     versions must give the same tables and make the same decisions on
     each (the search kernels also on seeded random states at the same
     shapes); the three kernels are timed on the last step's inputs
     (and the search kernels, printed only, on random states at larger
     fleets and grids);
  5b. drive the learning path (in-episode distillation, paper §3.4):
     run_fleet with distill=DistillSpec() (head-only AdamW, the paper's
     mode) and metrics=MetricsSpec() at the same cell, then with
     DistillSpec(head_only=False) at 3 steps (depth cut to stay inside
     the time limit), counters set to 0 just before and read just after:
     the four main-path kernels once per step and no other (the update
     launches none); every recorded oracle_pass, shape_search,
     budget_walk and crop_patchify call equal to its plain version; the
     per-step loss finite and >= 0; the learned heads moved; the
     backbone (full mode: the patch embedding) bit-unchanged. Prints
     steady_s, its ratio to the frozen run's, peak memory, the loss per
     step and the chosen_rank median; then the smoke detector with
     learning on, 2 cameras, 8 steps, on the card and on the CPU: equal
     decisions, loss and learned heads within stated tolerances;
  6. drive the ViT flash path: the main path's own crop_patchify tokens
     (64 cameras x 18 crops) through vit_features_tokens(impl="flash")
     with the counters set to 0 just before — flash_attention must launch
     once per layer — and through impl="xla"; both go on through the
     neck, heads and decode, and features and detections must agree;
  7. drive the kernel APIs (box_iou, nms_mask, match_boxes, frame_delta
     over one 1080p frame per camera, rmsnorm) with the counters set to
     0 just before and read just after; then time box_iou on those
     detections (the dense case) and nms_mask / match_boxes per call;
  8. drive the main path past the kernels' old limits: run_fleet at full
     width on the 200-cell 7.5-degree grid with a 40-slot scene, 16
     cameras, 3 steps, counters set to 0 just before and read just
     after (crop_patchify, oracle_pass, shape_search and budget_walk
     once per step, each call equal to its plain version); the same
     spec at 2 cameras on the card and on the CPU must decide alike;
     oracle_pass on a 256-slot scene;
  8b. drive the serving launcher (`repro_torch.launch.serve.serve`, the
     `python -m repro_torch.launch.serve` entry point) inside a trace
     (with NVTX ranges):
     at its defaults (5 fps, 20 s: 100 controller steps) with a
     64-camera `tables` fleet and JSONL telemetry, counters set to 0
     just before and read just after (shape_search and budget_walk once
     per step, 101 with the warm-up, and no other kernel; every call
     equal to its plain version); the spans fleet/build, fleet/compile
     and fleet/steady in the trace and every event valid; the same
     fleet through run_fleet(FleetRunSpec.from_objects("tables", ...))
     on the 200-cell grid (the kernels' four-word instances); serve
     --fleet 4 on the card and on the CPU (equal printed accuracies and
     decisions); and serve --fleet 8 --provider detector --shortlist-k
     18 --distill --telemetry over 5 steps (the four main-path kernels
     once per step and no other, each call equal to its plain version,
     events carrying distill_loss);
  9. time one step of the main path stage by stage (the scene advance
     and the oracle pass apart), then its learn stage: scoring through
     per-camera heads, teacher targets, ring harvest and the update,
     and count the operations of one learn hook that wait for the
     card (sync debug mode);
 10. print one JSON line describing every kernel (its launches on the
     detector main path; with `serve_launches` its launches on each
     path of phase 8b, and for the search kernels `tables_graph_ms`),
     the card line again, and as the last line {"ok": true, "device":
     {...}}.

Imports torch and the port (src/repro_torch) only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import re
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import DEFAULT_GRID, OrientationGrid  # noqa: E402
from repro_torch.core.tradeoff import BudgetConfig  # noqa: E402
from repro_torch.data import SceneConfig, build_video  # noqa: E402
from repro_torch.fleet.api import (  # noqa: E402
    FleetRunSpec,
    prepare_fleet_run,
    run_fleet,
)
from repro_torch.fleet.state import (  # noqa: E402
    fleet_config,
    fleet_statics,
    workload_spec,
)
from repro_torch.fleet import step as step_module  # noqa: E402
from repro_torch.fleet.step import FleetObs, fleet_step  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.box_iou.ops import (  # noqa: E402
    box_iou,
    box_iou_plain,
    match_boxes,
    nms_mask,
)
from repro_torch.kernels.cell_rasterize.ops import (  # noqa: E402
    cell_rasterize,
    cell_rasterize_plain,
)
from repro_torch.kernels.crop_patchify import (  # noqa: E402
    ops as patchify_module,
)
from repro_torch.kernels.crop_patchify.ops import (  # noqa: E402
    crop_patchify_batch,
    crop_patchify_plain,
)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.frame_delta.ops import (  # noqa: E402
    frame_delta,
    frame_delta_plain,
    frame_delta_tiles,
)
from repro_torch.kernels.neighbor_score.ops import (  # noqa: E402
    neighbor_score_batch,
    neighbor_score_plain,
)
from repro_torch.kernels.oracle_pass.ops import (  # noqa: E402
    oracle_pass,
    oracle_pass_plain,
)
from repro_torch.kernels.rmsnorm.ops import (  # noqa: E402
    rmsnorm,
    rmsnorm_plain,
)
from repro_torch.kernels.shape_search.ops import (  # noqa: E402
    budget_walk_batch,
    budget_walk_plain,
    shape_search_batch,
    shape_search_plain,
)
from repro_torch.learn.loop import distill_step  # noqa: E402
from repro_torch.learn.pairs import (  # noqa: E402
    harvest_into_buffer,
    select_sent_windows,
    teacher_window_targets,
)
from repro_torch.launch import serve as serve_module  # noqa: E402
from repro_torch.learn.spec import DistillSpec  # noqa: E402
from repro_torch.models.detector import (  # noqa: E402
    _decode_detections,
    detector_init,
    head_outputs,
    neck_features,
)
from repro_torch.obs.metrics import (  # noqa: E402
    MetricsSpec,
    median_valid_rank,
)
from repro_torch.models.vit import vit_features_tokens  # noqa: E402
from repro_torch.obs.events import read_events  # noqa: E402
from repro_torch.obs.trace import tracing  # noqa: E402
from repro_torch.scene import observe as observe_module  # noqa: E402
from repro_torch.scene.observe import (  # noqa: E402
    detections_obs,
    grid_windows,
    observe_all_cells,
    teacher_arrays,
)
from repro_torch.scene.render import (  # noqa: E402
    object_colors,
    render_background,
    render_noise,
)
from repro_torch.scene.scene import (  # noqa: E402
    SceneSpec,
    advance_scene,
    init_scene,
    kind_mask,
    scene_fleet_params,
)
from repro_torch.serving import (  # noqa: E402
    NetworkTrace,
    detection_tables,
    workload_acc_table,
)
from repro_torch.train.optim import tree_leaves  # noqa: E402

# the main path's cell: full-width madeye-approx, one step's shapes
N_CAMERAS, N_STEPS, SHORTLIST_K = 64, 8, 18
FULL_STEPS = 3          # the full-param distill episode's depth
N_CHANNELS = 8          # 4 workload pairs, student + teacher draws
MAIN_PATH_KERNELS = ("shape_search", "budget_walk", "oracle_pass",
                     "crop_patchify")
# the card's published peaks (NVIDIA H100 SXM data sheet: HBM3 bandwidth,
# float32 outside the tensor cores, dense TF32 and bf16 on the tensor
# cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12
PEAK_BF16_PER_S = 989e12
# float32 products on the tensor cores run in split TF32: three TF32
# products for each float32 one (csrc/wgmma.cuh)
SPLIT_TF32 = 3
TENSOR_CORE_KERNELS = ("crop_patchify", "flash_attention")
# stablelm-3b's attention (src/repro/configs/stablelm_3b.py: 32 heads of
# 80 dims, MHA), batch 2 at a 4096-token context
STABLELM_ATTN = dict(b=2, s=4096, h=32, d=80)
N_BOX_CAMERAS = 16      # box_iou: one step's detections of 16 cameras
# past the kernels' old limits: the 7.5-degree grid (200 cells, four-word
# cell sets), a 40-slot scene (two ownership words), 16 cameras
BIG_GRID = {"pan_step": 7.5, "tilt_step": 7.5}
BIG_SCENE = dict(max_people=24, max_cars=16)
BIG_CAMERAS, BIG_STEPS = 16, 3
# flash attention past 128 head dims (the MLA configs' 192-wide query /
# key heads, src/repro/configs/deepseek_v3_671b.py, and 256)
WIDE_ATTN = dict(b=2, s=1024, h=8)
# the serving launcher at its defaults (5 fps, 20 s of 15 fps video: 100
# controller steps); its detector branch over 5 steps (1 s)
SERVE = dict(fps=5.0, duration=20.0)
SERVE_STEPS = 100
SERVE_DETECTOR = dict(fps=5.0, duration=1.0, fleet=8, provider="detector",
                      shortlist_k=SHORTLIST_K, distill=True)
SEARCH_KERNELS = ("shape_search", "budget_walk")
FRAME = (1080, 1920, 3)  # frame_delta: one 1080p RGB frame per camera
RMS_SHAPE = (8, 4096, 2560)  # rmsnorm at stablelm-3b's d_model

SOURCES = {
    # the shape search's loops fused around the neighbor score; the TPU
    # kernel it replaces on the main path is neighbor_score's
    "shape_search": (
        "src/repro_torch/csrc/shape_search.cu",
        "src/repro/kernels/neighbor_score/neighbor_score.py:47"),
    # the reference's shrink-to-budget is an XLA while loop, no Pallas
    "budget_walk": (
        "src/repro_torch/csrc/shape_search.cu",
        "src/repro/fleet/step.py:207"),
    "neighbor_score": (
        "src/repro_torch/csrc/neighbor_score.cu",
        "src/repro/kernels/neighbor_score/neighbor_score.py:47"),
    "cell_rasterize": (
        "src/repro_torch/csrc/cell_rasterize.cu",
        "src/repro/kernels/cell_rasterize/cell_rasterize.py:89"),
    # the whole oracle pass around the rasterization; the TPU kernel it
    # replaces on the main path is cell_rasterize's
    "oracle_pass": (
        "src/repro_torch/csrc/oracle_pass.cu",
        "src/repro/kernels/cell_rasterize/cell_rasterize.py:89"),
    "crop_patchify": (
        "src/repro_torch/csrc/crop_patchify.cu",
        "src/repro/kernels/crop_patchify/crop_patchify.py:95"),
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:104"),
    "box_iou": (
        "src/repro_torch/csrc/box_iou.cu",
        "src/repro/kernels/box_iou/box_iou.py:49"),
    "frame_delta": (
        "src/repro_torch/csrc/frame_delta.cu",
        "src/repro/kernels/frame_delta/frame_delta.py:36"),
    "rmsnorm": (
        "src/repro_torch/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm/rmsnorm.py:27"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` back-to-back calls, after a
    warm-up, by CUDA events."""
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


def graph_ms(fn, iters: int) -> float:
    """Device time of fn() per call with no host cost between calls: one
    CUDA graph of `iters` back-to-back calls, captured after a warm-up
    and replayed once warm, timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def check_close(name, got, want, atol, rtol=0.0):
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"{name}[{i}]: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        bad = (g - w).abs() > atol + rtol * w.abs()
        if bool(bad.any()) or not bool(torch.isfinite(g).all()):
            raise AssertionError(
                f"{name}[{i}]: {int(bad.sum())} elements off by more than "
                f"atol={atol} rtol={rtol} (max abs err "
                f"{float((g - w).abs().max())})")


def bound(n_bytes: float, n_ops: float,
          peak_ops: float = PEAK_FP32_PER_S) -> tuple[float, str, str]:
    """(least ms, "bytes" or "operations", the rate it was taken at)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", "3.35 TB/s"
    rate = {PEAK_FP32_PER_S: "FP32 67 TFLOP/s",
            PEAK_TF32_PER_S: "3xTF32 at 495 TFLOP/s",
            PEAK_BF16_PER_S: "bf16 989 TFLOP/s"}[peak_ops]
    return t_ops, "operations", rate


def split_tf32_bound(n_bytes: float, n_flop: float) -> tuple[float, str,
                                                              str]:
    """The bound of a float32 product run in split TF32: three TF32
    operations for each float32 one, at the dense TF32 rate."""
    return bound(n_bytes, SPLIT_TF32 * n_flop, PEAK_TF32_PER_S)


def sass_mma_counts(path) -> dict:
    """Tensor-core instructions (HGMMA, HMMA) per kernel in the built
    library's SASS, by cuobjdump; {} where the toolkit has none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1]
            name = next((k for k in SOURCES if f"{k}_kernel" in fn), fn)
            counts.setdefault(name, {"HGMMA": 0, "HMMA": 0})
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if f" {op}." in line:
                    counts[name][op] += 1
    return counts


def main_path_inputs(dev):
    """One step's inputs at the main path's shapes, from a scene of
    N_CAMERAS cameras advanced a few frames (seeded)."""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen).to(dev)

    spec = SceneSpec()
    params, rng = scene_fleet_params(spec, N_CAMERAS, device=dev)
    sc = init_scene(spec, params, rng)
    sc = advance_scene(spec, params, rng, sc, 2, 4)
    grid = DEFAULT_GRID
    statics = fleet_statics(grid, dev)
    windows = grid_windows(grid, device=dev)
    n, c = grid.n_cells, windows.shape[0]
    m = spec.max_objects
    strips = [x.contiguous() for x in (sc.pos[..., 0], sc.pos[..., 1],
                                       sc.size[..., 0], sc.size[..., 1])]

    member_has = (rand(N_CAMERAS, n) < 0.4).float()
    cent = statics.centers[None] + 10.0 * (rand(N_CAMERAS, n, 2) - 0.5)
    ns_args = (member_has, cent[..., 0].contiguous(),
               cent[..., 1].contiguous(), statics.d_center,
               statics.overlap, statics.cell_x, statics.cell_y)

    draw = torch.where(rand(N_CAMERAS, N_CHANNELS, m) < 0.2, 2.0,
                       1.2 * rand(N_CAMERAS, N_CHANNELS, m))
    a0 = 0.05 + 0.05 * rand(N_CHANNELS)
    a1 = a0 + 0.1 + 0.1 * rand(N_CHANNELS)
    cr_args = (*strips, draw, a0, a1, windows)

    cfg = get_config("madeye-approx")
    res, patch, d = cfg.img_res, cfg.patch, cfg.d_model
    widx = torch.argsort(rand(N_CAMERAS, c), dim=-1)[:, :SHORTLIST_K]
    wins = windows[widx].contiguous()                       # [F, K, 4]
    kinds = torch.as_tensor(kind_mask(spec), device=dev)
    colors = object_colors(kinds, sc.oid).contiguous()
    bgn = (render_background(res, dev)[None]
           + 0.05 * render_noise(rng, 2, res)).contiguous()
    depth = patch * patch * 3
    wflat = (math.sqrt(2.0 / depth)
             * torch.randn((depth, d), generator=gen)).to(dev)
    bias = (0.01 * torch.randn(d, generator=gen)).to(dev)
    cp_args = (*strips, colors, wins, bgn, wflat, bias)
    cp_kw = dict(res=res, patch=patch, min_visible=spec.min_visible)
    return (ns_args, (cr_args, dict(min_visible=spec.min_visible,
                                    n_moment=N_CHANNELS // 2)),
            (cp_args, cp_kw))


def kernel_phase(dev) -> dict:
    """Each kernel against its plain version at the main path's shapes,
    with tolerances and reasons; both timed. Returns per-kernel rows."""
    ns_args, (cr_args, cr_kw), (cp_args, cp_kw) = main_path_inputs(dev)
    rows = {}

    # neighbor_score: same formula, the member sum in another order
    # (f32 round-off only) -> 1e-5 relative
    got = (neighbor_score_batch(*ns_args),)
    want = (neighbor_score_plain(*ns_args),)
    torch.cuda.synchronize()
    check_close("neighbor_score", got, want, atol=1e-5, rtol=1e-5)
    b, n = ns_args[0].shape
    n_bytes = 4 * (3 * b * n + 2 * n * n + 2 * n + b * n)
    rows["neighbor_score"] = dict(
        max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: neighbor_score_batch(*ns_args), 200),
        graph_ms=graph_ms(lambda: neighbor_score_batch(*ns_args), 200),
        plain_ms=cuda_ms(lambda: neighbor_score_plain(*ns_args), 200),
        bound=bound(n_bytes, 12 * b * n * n))

    # cell_rasterize: counts are exact integers and must agree exactly;
    # areas and moments are f32 sums over objects in another order ->
    # 1e-5 absolute + 1e-5 relative (the moments reach ~1e6 deg^2)
    got = cell_rasterize(*cr_args, **cr_kw)
    want = cell_rasterize_plain(*cr_args, **cr_kw)
    torch.cuda.synchronize()
    check_close("cell_rasterize.cnt", got[:1], want[:1], atol=0.0)
    check_close("cell_rasterize", got[1:], want[1:], atol=1e-5, rtol=1e-5)
    f, m = cr_args[0].shape
    p = cr_args[4].shape[1]
    c = cr_args[7].shape[0]
    n_bytes = 4 * (4 * f * m + f * p * m + 2 * p + 4 * c
                   + 2 * f * p * c + 4 * f * c)
    # per (camera, object, window): ~25 geometry ops + ~6 per channel
    rows["cell_rasterize"] = dict(
        max_abs_err=max_err(got[1:], want[1:]),
        ms=cuda_ms(lambda: cell_rasterize(*cr_args, **cr_kw), 200),
        graph_ms=graph_ms(lambda: cell_rasterize(*cr_args, **cr_kw), 200),
        plain_ms=cuda_ms(lambda: cell_rasterize_plain(*cr_args, **cr_kw),
                         50),
        bound=bound(n_bytes, f * m * c * (25 + 6 * p)))

    # crop_patchify: identical pixels, the 768-term token product in split
    # TF32 on the tensor cores (~2^-22 relative per term) against
    # torch.matmul's float32 -> 1e-4 absolute on tokens of order 1
    got = (crop_patchify_batch(*cp_args, **cp_kw),)
    want = (crop_patchify_plain(*cp_args, **cp_kw),)
    torch.cuda.synchronize()
    check_close("crop_patchify", got, want, atol=1e-4)
    rows["crop_patchify"] = dict(
        max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: crop_patchify_batch(*cp_args, **cp_kw), 10),
        plain_ms=cuda_ms(lambda: crop_patchify_plain(*cp_args, **cp_kw),
                         5),
        bound=patchify_bound(cp_args, cp_kw))
    for name, r in rows.items():
        print_row(name, r)
    return rows


def patchify_bound(cp_args, cp_kw) -> tuple[float, str, str]:
    """crop_patchify's bound on its arguments: the object strips,
    colours, windows, plane and weights read once and the tokens written
    once, against the split-TF32 product."""
    f, m = cp_args[0].shape
    k = cp_args[5].shape[-2]
    res, patch = cp_kw["res"], cp_kw["patch"]
    depth, d = cp_args[7].shape
    gg = (res // patch) ** 2
    n_bytes = 4 * (4 * f * m + 3 * f * m + f * k * 4 + f * res * res * 3
                   + depth * d + d + f * k * gg * d)
    return split_tf32_bound(n_bytes, 2.0 * f * k * gg * depth * d)


def print_row(name: str, r: dict) -> None:
    lib = r.get("library_ms")
    graph = (f" graph_ms={r['graph_ms']:.6f}" if "graph_ms" in r else "")
    print(f"kernel {name}: max_abs_err={r['max_abs_err']:.3e} "
          f"ms={r['ms']:.6f}{graph} plain_ms={r['plain_ms']:.6f} "
          f"bound_ms={r['bound'][0]:.6f} ({r['bound'][1]}, "
          f"{r['bound'][2]}) library_ms="
          + ("null" if lib is None else f"{lib:.6f}"), flush=True)


def attn_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """Unmasked (query, key) pairs: what the kernel's work depends on."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i + q_offset + 1)) for i in range(sq))


def flash_case(dev, b, sq, sk, hq, hkv, d, *, causal=False, q_offset=0,
               dtype=torch.float32, iters=10, plain_iters=3,
               library=False) -> dict:
    """flash_attention against its plain version on seeded N(0, 1)
    inputs (logits of unit scale), timed beside its bound."""
    gen = torch.Generator(device=dev).manual_seed(sq * 131 + d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                             (b, sk, hkv, d)))
    kw = dict(causal=causal, q_offset=q_offset)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    # float32: split-TF32 products (~2^-22 relative per term) and the
    # online softmax summed in another order (3e-5 on outputs of order
    # 1); bf16: P and the output rounded to bf16 (2e-2)
    tol = 2e-2 if dtype == torch.bfloat16 else 3e-5
    name = (f"flash_attention[{b}x{sq}x{hq}x{d} kv {sk}x{hkv} "
            f"causal={causal} q_offset={q_offset} {str(dtype)[6:]}]")
    check_close(name, (got.float(),), (want.float(),), atol=tol, rtol=tol)
    es = q.element_size()
    n_bytes = es * (2 * b * sq * hq * d + 2 * b * sk * hkv * d)
    n_ops = 4.0 * b * hq * attn_pairs(sq, sk, causal, q_offset) * d
    lim = (bound(n_bytes, n_ops, PEAK_BF16_PER_S) if dtype == torch.bfloat16
           else split_tf32_bound(n_bytes, n_ops))
    row = dict(max_abs_err=float((got.float() - want.float()).abs().max()),
               ms=cuda_ms(lambda: flash_attention(q, k, v, **kw), iters),
               plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v, **kw),
                                plain_iters),
               bound=lim, library_ms=None)
    del got, want
    if library:
        # PyTorch's own fused attention on the same inputs in [B, H, S, D]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        row["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal), iters)
    print_row(name, row)
    return row


def delta_frames(n: int, dev, seed: int):
    """n (cur, prev) frame pairs [n, *FRAME]: each 16 x 128 tile moves by
    N(0, sigma) noise with sigma 0.002 (still), 0.025 (at tau's edge) or
    0.05 (moving)."""
    h, w, c = FRAME
    gen = torch.Generator(device=dev).manual_seed(seed)
    prev = torch.rand((n, h, w, c), generator=gen, device=dev)
    sig = torch.tensor([0.002, 0.025, 0.05], device=dev)[torch.randint(
        0, 3, (n, -(-h // 16), -(-w // 128)), generator=gen, device=dev)]
    sig = sig.repeat_interleave(16, 1)[:, :h]
    sig = sig.repeat_interleave(128, 2)[..., :w]
    cur = prev + sig[..., None] * torch.randn((n, h, w, c), generator=gen,
                                              device=dev)
    return cur, prev


def check_frame_delta(cur, prev, dq, changed, name) -> tuple[int, int]:
    """changed equal except on tiles whose plain mean lies within 1e-6 of
    tau (a sum in another order may flip them); int8 residuals equal
    wherever both sides agree on the tile. Returns (max |int8 difference|
    over the whole frame, tiles flipped)."""
    h, w, c = cur.shape
    dq_p, changed_p = frame_delta_plain(cur, prev)
    d = F.pad(cur - prev, (0, 0, 0, (-w) % 128, 0, (-h) % 16))
    mean = d.abs().reshape(d.shape[0] // 16, 16, d.shape[1] // 128, 128,
                           c).mean(dim=(1, 3, 4))
    agree = changed == changed_p
    if not bool((agree | ((mean - 0.02).abs() < 1e-6)).all()):
        raise AssertionError(f"{name}: changed differs away from tau")
    px = agree.repeat_interleave(16, 0)[:h].repeat_interleave(128, 1)[:, :w]
    if not bool(((dq == dq_p) | ~px[..., None]).all()):
        raise AssertionError(f"{name}: int8 residuals differ")
    return (int((dq.int() - dq_p.int()).abs().max()),
            int((~agree).sum()))


def new_kernel_phase(dev) -> dict:
    """flash_attention, box_iou, frame_delta and rmsnorm against their
    plain versions at full-size shapes (tolerances and reasons inline),
    timed beside their bounds and, where one PyTorch call computes the
    same function, that call. Returns per-kernel rows."""
    rows = {}
    # flash_attention: the ViT's layer (64 cameras x 18 crops, 197
    # tokens, 6 heads of 32) is the row; stablelm-3b's causal width, GQA
    # with q_offset and bf16 are cases
    rows["flash_attention"] = flash_case(
        dev, N_CAMERAS * SHORTLIST_K, 197, 197, 6, 6, 32, iters=20,
        plain_iters=5, library=True)
    sl = STABLELM_ATTN
    flash_case(dev, sl["b"], sl["s"], sl["s"], sl["h"], sl["h"], sl["d"],
               causal=True, iters=5, plain_iters=2, library=True)
    flash_case(dev, 4, 100, 164, 8, 2, 64, causal=True, q_offset=64)
    flash_case(dev, 64, 256, 256, 8, 8, 64, dtype=torch.bfloat16)
    wa = WIDE_ATTN
    for d in (192, 256):
        for dtype in (torch.float32, torch.bfloat16):
            flash_case(dev, wa["b"], wa["s"], wa["s"], wa["h"], wa["h"], d,
                       causal=True, dtype=dtype, iters=10, plain_iters=2,
                       library=True)

    # box_iou: the same float32 ops in the same order (a division skipped
    # where inter == 0 is exact) -> bit-equal
    n = N_BOX_CAMERAS * SHORTLIST_K * 32
    gen = torch.Generator(device=dev).manual_seed(1)

    def boxes():
        return torch.cat([torch.rand((n, 2), generator=gen, device=dev),
                          0.02 + 0.3 * torch.rand((n, 2), generator=gen,
                                                  device=dev)], 1)

    a, b = boxes(), boxes()
    rows["box_iou"] = box_iou_row(a, b, "random boxes")

    # frame_delta on one 1080p frame
    cur, prev = (x[0] for x in delta_frames(1, dev, 2))
    dq, changed = frame_delta_tiles(cur, prev)
    torch.cuda.synchronize()
    err, flipped = check_frame_delta(cur, prev, dq, changed, "frame_delta")
    print(f"frame_delta: {flipped} of {changed.numel()} tiles flipped "
          f"(plain mean within 1e-6 of tau), max |int8 difference| {err}",
          flush=True)
    h, w, c = FRAME
    gg = changed.numel()
    rows["frame_delta"] = dict(
        max_abs_err=float(err),
        ms=cuda_ms(lambda: frame_delta_tiles(cur, prev), 100),
        graph_ms=graph_ms(lambda: frame_delta_tiles(cur, prev), 100),
        plain_ms=cuda_ms(lambda: frame_delta_plain(cur, prev), 20),
        bound=bound(h * w * c * (4 + 4 + 1) + 4 * gg, 6.0 * h * w * c),
        library_ms=None)
    print_row("frame_delta", rows["frame_delta"])

    # rmsnorm: a 2560-term sum of squares in another order and a
    # correctly rounded 1/sqrt against torch.rsqrt -> 1e-5
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(RMS_SHAPE, generator=gen, device=dev)
    wt = torch.randn(RMS_SHAPE[-1], generator=gen, device=dev) + 1.0
    got, want = rmsnorm(x, wt), rmsnorm_plain(x, wt)
    torch.cuda.synchronize()
    check_close("rmsnorm", (got,), (want,), atol=1e-5, rtol=1e-5)
    err = max_err((got,), (want,))
    del got, want
    rows["rmsnorm"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: rmsnorm(x, wt), 20),
        plain_ms=cuda_ms(lambda: rmsnorm_plain(x, wt), 10),
        bound=bound(4 * (2 * x.numel() + wt.numel()), 4.0 * x.numel()),
        library_ms=cuda_ms(lambda: F.rms_norm(x, (RMS_SHAPE[-1],), wt,
                                              eps=1e-6), 20))
    print_row("rmsnorm", rows["rmsnorm"])
    return rows


def box_iou_row(a, b, label: str) -> dict:
    """box_iou bit-equal to its plain version on a [N, 4] x [M, 4], timed
    beside its bound (the [N, M] float32 output written once); prints
    the share of pairs that intersect (a division each) and of the
    bound."""
    got, want = box_iou(a, b), box_iou_plain(a, b)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"box_iou ({label}): not bit-equal to the "
                             f"plain version (max abs err "
                             f"{max_err((got,), (want,))})")
    n, m = a.shape[0], b.shape[0]
    hit = float((got > 0).float().mean())
    del want
    # the yardstick of a store stream: a write-only pass over the output
    zero_ms = cuda_ms(got.zero_, 50)
    del got
    # ~13 operations per pair (4 min/max, 4 sub/add, 2 clamps, 1 product,
    # 1 max, 1 division)
    row = dict(max_abs_err=0.0, ms=cuda_ms(lambda: box_iou(a, b), 50),
               graph_ms=graph_ms(lambda: box_iou(a, b), 50),
               plain_ms=cuda_ms(lambda: box_iou_plain(a, b), 10),
               bound=bound(4 * (4 * n + 4 * m + n * m), 13.0 * n * m),
               library_ms=None)
    print(f"box_iou ({label}, {n} x {m}): bit-equal to the plain version; "
          f"{hit:.3f} of the pairs intersect; graph_ms at "
          f"{row['bound'][0] / row['graph_ms']:.3f} of the bound; a "
          f"write-only Tensor.zero_ of the output {zero_ms:.4f} ms",
          flush=True)
    print_row("box_iou", row)
    return row


def small_parity_phase() -> None:
    """The whole port on a small input, card vs CPU: same decisions."""
    spec = FleetRunSpec(provider="detector", n_cameras=3, n_steps=3,
                        shortlist_k=SHORTLIST_K)
    on_card = run_fleet(spec)
    on_cpu = run_fleet(spec, device="cpu")
    if (on_card.chosen != on_cpu.chosen
            or on_card.frames_sent != on_cpu.frames_sent):
        raise AssertionError(
            f"card vs CPU decisions differ: {on_card.chosen} "
            f"{on_card.frames_sent} vs {on_cpu.chosen} "
            f"{on_cpu.frames_sent}")
    err = max(abs(a - b) for a, b in zip(on_card.acc_per_step,
                                         on_cpu.acc_per_step))
    if err > 1e-6:
        raise AssertionError(f"card vs CPU accuracy differs by {err}")
    print(f"small input: card and CPU agree (chosen {on_card.chosen}, "
          f"frames_sent {on_card.frames_sent})", flush=True)


class SearchRecorder:
    """While active, records the arguments and results of every
    shape_search and budget_walk call that fleet_step makes (clones, by
    wrapping the names fleet/step.py calls). The wrapped call is the
    wrapper itself, launched once as always."""

    NAMES = ("shape_search_batch", "budget_walk_batch")

    def __init__(self):
        self.calls = {name: [] for name in self.NAMES}

    def _wrap(self, name, fn):
        def recorded(cfg, statics, *args):
            out = fn(cfg, statics, *args)
            self.calls[name].append((cfg, statics, _clone(args),
                                     _clone(out)))
            return out
        return recorded

    def __enter__(self):
        self.saved = {n: getattr(step_module, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            setattr(step_module, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(step_module, name, fn)


class OracleRecorder:
    """While active, records the arguments and results of every
    oracle_pass call that observe_all_cells makes (clones, by wrapping
    the name scene/observe.py calls). The wrapped call is the wrapper
    itself, launched once as always."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.saved = observe_module.oracle_pass

        def recorded(*args, **kwargs):
            out = self.saved(*args, **kwargs)
            self.calls.append((_clone(args), _clone(kwargs), _clone(out)))
            return out

        observe_module.oracle_pass = recorded
        return self

    def __exit__(self, *exc):
        observe_module.oracle_pass = self.saved


class PatchifyRecorder:
    """While active, records the arguments and result of every
    crop_patchify kernel call (clones, by wrapping crop_patchify_batch,
    the name kernels/crop_patchify/ops.crop_patchify calls). The wrapped
    call is the wrapper itself, launched once as always."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.saved = patchify_module.crop_patchify_batch

        def recorded(*args, **kwargs):
            out = self.saved(*args, **kwargs)
            self.calls.append((_clone(args), _clone(kwargs), out.clone()))
            return out

        patchify_module.crop_patchify_batch = recorded
        return self

    def __exit__(self, *exc):
        patchify_module.crop_patchify_batch = self.saved


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):            # NamedTuples keep their type
        vals = [_clone(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


def _launched_only(counts, kernels, n, label) -> None:
    """Raise unless exactly `kernels` launched, each `n` times."""
    uneven = [k for k in kernels if counts[k] != n]
    stray = [k for k, v in counts.items() if v and k not in kernels]
    if uneven or stray:
        raise AssertionError(f"{label}: launches {counts}, want "
                             f"{kernels} x {n} only")


def main_path_phase(spec: FleetRunSpec):
    """Drive run_fleet once at the main path's cell; return (result,
    launch counts of that run, the recorded shape-search calls, the
    recorded oracle-pass calls)."""
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    with SearchRecorder() as rec, OracleRecorder() as orec:
        result = run_fleet(spec)
    counts = _lib.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    chosen = torch.tensor(result.chosen)
    acc = torch.tensor(result.acc_per_step)
    if chosen.shape != (N_STEPS, N_CAMERAS):
        raise AssertionError(f"chosen has shape {tuple(chosen.shape)}")
    if not bool(((chosen >= 0) & (chosen < DEFAULT_GRID.n_cells)).all()):
        raise AssertionError("chosen cell out of range")
    if not (bool(torch.isfinite(acc).all()) and bool((acc >= 0).all())
            and bool((acc <= 1).all())):
        raise AssertionError(f"accuracy not in [0, 1]: {acc}")
    if len(result.frames_sent) != N_STEPS or min(result.frames_sent) < 0:
        raise AssertionError(f"frames_sent malformed: "
                             f"{result.frames_sent}")
    missing = [k for k in MAIN_PATH_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    uneven = [k for k in MAIN_PATH_KERNELS if counts[k] != N_STEPS + 1]
    if uneven:
        raise AssertionError(f"main-path kernels not launched once per "
                             f"step: {uneven} ({counts})")
    stray = [k for k, v in counts.items()
             if v and k not in MAIN_PATH_KERNELS]
    if stray:
        raise AssertionError(f"kernels off the main path launched on it: "
                             f"{stray}")
    t = result.timings
    print(f"main path: accuracy={result.accuracy:.6f} "
          f"frames_sent={list(result.frames_sent)} "
          f"compile_s={t['compile_s']:.3f} steady_s={t['steady_s']:.3f} "
          f"camera_steps_per_s={result.camera_steps_per_s:.2f} "
          f"peak_mem_gib={peak:.2f} launches={counts} "
          f"(over {N_STEPS} steps + 1 warm-up step)", flush=True)
    return result, counts, rec.calls, orec.calls


def oracle_phase(calls, steps: int = N_STEPS + 1, tag: str = "") -> dict:
    """oracle_pass against its plain version on the inputs of every step
    of the main-path episode: counts, nbox and acc_true exactly equal;
    areas, centroid and extent within 1e-5 (absolute + relative: float32
    sums over objects in another order), the spread within 1e-2 as a
    variance (it cancels: the tolerance of the CPU tests against the JAX
    package). Timed on the last step's inputs (ms: Python calls;
    graph_ms: a CUDA graph of the calls). Returns its row."""
    if len(calls) != steps:
        raise AssertionError(f"oracle_pass: {len(calls)} calls recorded, "
                             f"want {steps}")
    errs = {k: 0.0 for k in ("areas", "centroid", "extent", "spread")}
    for step, (args, kw, got) in enumerate(calls):
        want = oracle_pass_plain(*args, **kw)
        for name in ("counts", "nbox", "acc_true"):
            g, w = getattr(got, name), getattr(want, name)
            if not torch.equal(g, w):
                raise AssertionError(
                    f"oracle_pass step {step}: {name} differs from the "
                    f"plain version in {int((g != w).sum())} places")
        for name in ("areas", "centroid", "extent"):
            check_close(f"oracle_pass step {step} {name}",
                        (getattr(got, name),), (getattr(want, name),),
                        atol=1e-5, rtol=1e-5)
        check_close(f"oracle_pass step {step} spread^2",
                    (got.spread ** 2,), (want.spread ** 2,), atol=1e-2,
                    rtol=1e-5)
        for name in errs:
            errs[name] = max(errs[name], max_err((getattr(got, name),),
                                                 (getattr(want, name),)))
    args, kw, got = calls[-1]
    _, teach, _, state, _, windows = args
    f, m = state.oid.shape
    p = teach.a0.shape[0]
    c = windows.shape[0]
    q = len(kw["pair_idx"])
    # inputs: pos, size, oid, enabled, t, cam_salt, 4 f32 + 2 i64 teacher
    # rows, windows, the queries (kernel parameters); outputs:
    # counts/areas, centroid, spread, extent, acc_true (f32), nbox (i64)
    n_bytes = (f * m * (8 + 8 + 8 + 1) + 16 * f + p * (16 + 16) + 16 * c
               + 8 * q + f * c * (8 * p + 8 + 12 + 8))
    # per (camera, object, window): ~25 geometry ops + ~6 per channel of
    # 2P; per (camera, pair, object): three hashes of ~24 ops
    n_ops = f * m * c * (25 + 12 * p) + f * p * m * 72

    def run():
        return oracle_pass(*args, **kw)

    row = dict(max_abs_err=max(errs.values()),
               ms=cuda_ms(run, 200), graph_ms=graph_ms(run, 200),
               plain_ms=cuda_ms(lambda: oracle_pass_plain(*args, **kw), 20),
               bound=bound(n_bytes, n_ops), library_ms=None)
    exact = all(torch.equal(getattr(got, k), getattr(want, k))
                for k in errs)
    print(f"oracle_pass{tag}: kernel and plain agree on all {len(calls)} "
          f"steps "
          f"of the episode (counts, nbox, acc_true exact; max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; last step's floats exactly equal: {exact})", flush=True)
    print_row("oracle_pass" + tag, row)
    return row


def search_phase(calls, steps: int = N_STEPS + 1, tag: str = "") -> dict:
    """shape_search and budget_walk against their plain versions on the
    inputs of every step of the main-path episode: masks, walk orders and
    counts exactly equal, the walk time within 1e-6 relative (its hop sum
    in another order). Both timed on the last step's inputs (ms: Python
    calls; graph_ms: a CUDA graph of the calls). Returns their rows."""
    rows = {}
    plains = {"shape_search_batch": shape_search_plain,
              "budget_walk_batch": budget_walk_plain}
    wrappers = {"shape_search_batch": shape_search_batch,
                "budget_walk_batch": budget_walk_batch}
    for name, recorded in calls.items():
        kernel = name[:-len("_batch")]
        if len(recorded) != steps:
            raise AssertionError(f"{kernel}: {len(recorded)} calls recorded, "
                                 f"want {steps}")
        err = 0.0
        for step, (cfg, statics, args, got) in enumerate(recorded):
            want = plains[name](cfg, statics, *args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for i, (g, w) in enumerate(zip(got, want)):
                if g.dtype == torch.float32:
                    check_close(f"{kernel} step {step} t", (g,), (w,),
                                atol=0.0, rtol=1e-6)
                    err = max(err, float((g - w).abs().max()))
                elif not torch.equal(g, w):
                    bad = (g != w).reshape(g.shape[0], -1).any(1)
                    cams = torch.nonzero(bad).flatten().tolist()
                    raise AssertionError(
                        f"{kernel} step {step} output {i}: cameras {cams} "
                        f"decide otherwise than the plain version")
        cfg, statics, args, _ = recorded[-1]
        f, n = args[0].shape
        if kernel == "shape_search":
            n_bytes = (f * n * (1 + 4 + 8 + 1 + 1) + 8 * f + 9 * n * n
                       + 8 * n)
        else:
            n_bytes = f * n * (1 + 4 + 1 + 8) + 24 * f + 14 * n * n

        def run(fn=wrappers[name]):
            return fn(cfg, statics, *args)

        rows[kernel] = dict(
            max_abs_err=err, ms=cuda_ms(run, 200), graph_ms=graph_ms(run, 200),
            plain_ms=cuda_ms(lambda: plains[name](cfg, statics, *args), 3),
            # a search that may stop at its first test needs no fixed
            # count of operations: the bound is the bytes
            bound=bound(n_bytes, 0.0), library_ms=None)
        print(f"{kernel}{tag}: kernel and plain decide alike on all "
              f"{len(recorded)} steps of the episode", flush=True)
        print_row(kernel + tag, rows[kernel])
    return rows


def random_search_args(dev, grid, f: int, seed: int):
    """Seeded search states with ties: scattered shapes of up to half the
    grid (the head/tail loop, structural tails, shrinking), labels in
    quarters (many zeros), budgets that fit nothing, everything or in
    between. -> (cfg, statics, shape_search args, budget_walk args)."""
    gen = torch.Generator().manual_seed(seed)
    n = grid.n_cells

    def rand(*shape):
        return torch.rand(shape, generator=gen)

    shape = rand(f, n) < 0.5 * rand(f, 1)
    labels = torch.floor(4 * rand(f, n)) / 4
    has = rand(f, n) < 0.6
    cent = (torch.as_tensor(grid.centers, dtype=torch.float32)[None]
            + 12.0 * (rand(f, n, 2) - 0.5))
    max_cells = torch.randint(0, n + 3, (f,), generator=gen)
    start = torch.randint(0, n, (f,), generator=gen)
    budget = 0.6 * rand(f)
    budget[::5] = 0.0
    budget[1::5] = 1e3
    ss = [x.to(dev) for x in (shape, labels, cent, has, max_cells)]
    bw = [ss[0], start.to(dev), ss[1], budget.to(dev), 0.0]
    return fleet_config(grid), fleet_statics(grid, dev), ss, bw


def random_search_phase(dev) -> None:
    """shape_search and budget_walk against their plain versions on
    seeded states at the main path's shapes (64 cameras, 25 cells):
    decisions exactly equal, the walk time within 1e-6 relative. Then
    their device times (CUDA graph) at larger fleets and grids."""
    for seed in range(3):
        cfg, st, ss, bw = random_search_args(dev, DEFAULT_GRID, N_CAMERAS,
                                             seed)
        pairs = ((shape_search_batch(cfg, st, *ss),
                  shape_search_plain(cfg, st, *ss)),
                 *zip(budget_walk_batch(cfg, st, *bw),
                      budget_walk_plain(cfg, st, *bw)))
        for i, (got, want) in enumerate(pairs):
            if got.dtype == torch.float32:
                check_close(f"random state {seed} t", (got,), (want,),
                            atol=0.0, rtol=1e-6)
            elif not torch.equal(got, want):
                raise AssertionError(f"random state {seed} output {i}: "
                                     f"kernel and plain decide otherwise")
    print("shape_search, budget_walk: kernel and plain decide alike on 3 "
          f"random states of {N_CAMERAS} cameras x 25 cells", flush=True)
    big = OrientationGrid(pan_step=9.375, tilt_step=9.375)     # 16 x 8
    times = []
    for grid in (DEFAULT_GRID, big):
        for f in (N_CAMERAS, 1024):
            cfg, st, ss, bw = random_search_args(dev, grid, f, 7)
            ss_ms = graph_ms(lambda: shape_search_batch(cfg, st, *ss), 20)
            bw_ms = graph_ms(lambda: budget_walk_batch(cfg, st, *bw), 20)
            times.append(f"F={f} N={grid.n_cells}: shape_search "
                         f"{ss_ms:.4f} budget_walk {bw_ms:.4f}")
    print("search kernels on random states, graph_ms per call: "
          + "; ".join(times), flush=True)


def patchify_phase(calls, steps: int, tag: str) -> dict:
    """crop_patchify against its plain version on the inputs of every
    recorded call of an episode (tokens within 1e-4, as in kernel_phase),
    timed on the last call's inputs. Returns its row."""
    if len(calls) != steps:
        raise AssertionError(f"crop_patchify: {len(calls)} calls "
                             f"recorded, want {steps}")
    err = 0.0
    for step, (args, kw, got) in enumerate(calls):
        want = crop_patchify_plain(*args, **kw)
        check_close(f"crop_patchify{tag} step {step}", (got,), (want,),
                    atol=1e-4)
        err = max(err, max_err((got,), (want,)))
    args, kw, _ = calls[-1]
    print(f"crop_patchify{tag}: kernel and plain agree on all {steps} "
          f"steps (max abs err {err:.3e})", flush=True)
    row = dict(
        max_abs_err=err, ms=cuda_ms(lambda: crop_patchify_batch(*args, **kw),
                                    10),
        plain_ms=cuda_ms(lambda: crop_patchify_plain(*args, **kw), 3),
        bound=patchify_bound(args, kw), library_ms=None)
    print_row("crop_patchify" + tag, row)
    return row


def beyond_limits_phase(dev) -> None:
    """The main path past the kernels' old limits: run_fleet(provider=
    "detector") at full width on the 200-cell grid with a 40-slot scene,
    BIG_CAMERAS cameras, BIG_STEPS steps (+1 warm-up), counters set to 0
    just before and read just after: crop_patchify, oracle_pass,
    shape_search and budget_walk launch once per step, and every
    recorded call equals its plain version on the same inputs on the
    card, each timed on its last call. Then the same spec at 2 cameras
    with the smoke detector on the card and on the CPU must decide
    alike, and oracle_pass runs a 256-slot scene."""
    steps = BIG_STEPS + 1
    spec = FleetRunSpec(
        provider="detector", n_cameras=BIG_CAMERAS, n_steps=BIG_STEPS,
        shortlist_k=SHORTLIST_K, grid=BIG_GRID,
        provider_kwargs={"det_cfg": get_config("madeye-approx"),
                         "spec": SceneSpec(**BIG_SCENE)})
    n_cells = OrientationGrid(**BIG_GRID).n_cells
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    with (SearchRecorder() as rec, OracleRecorder() as orec,
          PatchifyRecorder() as prec):
        result = run_fleet(spec)
    torch.cuda.synchronize()
    counts = _lib.launch_counts()
    _launched_only(counts, MAIN_PATH_KERNELS, steps,
                   "beyond the old limits")
    chosen = torch.tensor(result.chosen)
    acc = torch.tensor(result.acc_per_step)
    if (chosen.shape != (BIG_STEPS, BIG_CAMERAS)
            or not bool(((chosen >= 0) & (chosen < n_cells)).all())
            or not bool(((acc >= 0) & (acc <= 1)).all())):
        raise AssertionError(f"beyond the old limits: malformed result "
                             f"{result.chosen} {result.acc_per_step}")
    print(f"beyond the old limits: {n_cells} cells, "
          f"{sum(BIG_SCENE.values())} slots, {BIG_CAMERAS} cameras x "
          f"{BIG_STEPS} steps: accuracy={result.accuracy:.6f} "
          f"frames_sent={list(result.frames_sent)} launches={counts}",
          flush=True)
    tag = f"[{n_cells} cells, M={sum(BIG_SCENE.values())}]"
    oracle_phase(orec.calls, steps, tag)
    search_phase(rec.calls, steps, tag)
    patchify_phase(prec.calls, steps, tag)

    # the same spec, 2 cameras, the smoke detector: card vs CPU
    small = dataclasses.replace(spec, n_cameras=2, provider_kwargs={
        "spec": SceneSpec(**BIG_SCENE)})
    on_card, on_cpu = run_fleet(small), run_fleet(small, device="cpu")
    same = (on_card.chosen == on_cpu.chosen
            and on_card.frames_sent == on_cpu.frames_sent
            and all(torch.equal(getattr(on_card.out, k).cpu(),
                                getattr(on_cpu.out, k))
                    for k in ("explored", "order", "zooms", "sent")))
    if not same:
        raise AssertionError(f"beyond the old limits: card vs CPU "
                             f"decisions differ: {on_card.chosen} vs "
                             f"{on_cpu.chosen}")
    print(f"beyond the old limits, small input: card and CPU agree "
          f"(chosen {on_card.chosen})", flush=True)

    # oracle_pass on a 256-slot scene (8 chunks of 32 objects)
    sspec = SceneSpec(max_people=128, max_cars=128)
    params, rng = scene_fleet_params(sspec, N_CAMERAS, device=dev)
    sc = advance_scene(sspec, params, rng, init_scene(sspec, params, rng),
                       2, 4)
    wl = workload_spec(FleetRunSpec().workload_obj())
    teach = teacher_arrays(wl.pairs, device=dev)
    oargs = (sspec, teach, params, sc,
             torch.full((N_CAMERAS,), 6, dtype=torch.int64, device=dev),
             grid_windows(DEFAULT_GRID, device=dev))
    okw = dict(task_id=wl.task_id, pair_idx=wl.pair_idx, n_zoom=3,
               cam_salt=rng[:, 0])
    _lib.reset_launch_counts()
    got = oracle_pass(*oargs, **okw)
    if _lib.launch_counts()["oracle_pass"] != 1:
        raise AssertionError("oracle_pass at 256 slots did not launch")
    oracle_phase([(oargs, okw, got)], 1, "[25 cells, M=256]")


class FleetRecorder:
    """While active, keeps the FleetResult of every run_fleet call the
    serving launcher makes (by wrapping the name launch/serve.py calls)."""

    def __init__(self):
        self.results = []

    def __enter__(self):
        self.saved = serve_module.run_fleet

        def recorded(*args, **kwargs):
            result = self.saved(*args, **kwargs)
            self.results.append(result)
            return result

        serve_module.run_fleet = recorded
        return self

    def __exit__(self, *exc):
        serve_module.run_fleet = self.saved


ACC_LINE = re.compile(r"^(.+?)\s*:\s*acc=([0-9.]+)", re.M)


def _serve(**kwargs):
    """serve(**kwargs) with its printout captured -> (the printout, the
    {line label: accuracy} it printed, the FleetResults it made)."""
    buf = io.StringIO()
    with FleetRecorder() as frec, contextlib.redirect_stdout(buf):
        serve_module.serve(**kwargs)
    out = buf.getvalue()
    accs = {k.strip(): v for k, v in ACC_LINE.findall(out)}
    return out, accs, frec.results


def _check_tables_result(result, n_cells, label) -> None:
    chosen = torch.tensor(result.chosen)
    acc = torch.tensor(result.acc_per_step)
    if (chosen.shape != (SERVE_STEPS, N_CAMERAS)
            or not bool(((chosen >= 0) & (chosen < n_cells)).all())
            or not bool(torch.isfinite(acc).all())
            or not bool(((acc >= 0) & (acc <= 1)).all())):
        raise AssertionError(f"{label}: malformed result {result.chosen} "
                             f"{result.acc_per_step}")
    # one shared world: every camera decides alike
    for k in ("explored", "order", "zooms", "sent", "chosen"):
        x = getattr(result.out, k)
        if not torch.equal(x, x[:, :1].expand_as(x)):
            raise AssertionError(f"{label}: cameras of the shared world "
                                 f"disagree on {k}")


def serve_phase(dev) -> dict:
    """The serving launcher on the card (phase 8b); returns the search
    kernels' rows of its two tables episodes and every path's launches."""
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    events_path = out_dir / "serve_events.jsonl"
    trace_path = out_dir / "serve_trace.json"
    events_path.unlink(missing_ok=True)
    steps = SERVE_STEPS + 1
    paths, rows = {}, {}

    # serve --fleet 64 at its defaults, telemetry to a file, in a trace
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    with (tracing(str(trace_path), nvtx=True) as tracer,
          SearchRecorder() as rec):
        out, _, (result,) = _serve(**SERVE, fleet=N_CAMERAS,
                                   provider="tables",
                                   telemetry=str(events_path))
    torch.cuda.synchronize()
    counts = _lib.launch_counts()
    print(out.rstrip(), flush=True)
    label = f"serve --fleet {N_CAMERAS} [tables, 25 cells]"
    _launched_only(counts, SEARCH_KERNELS, steps, label)
    paths[label] = counts
    _check_tables_result(result, DEFAULT_GRID.n_cells, label)
    events = read_events(str(events_path))
    kinds = [e["event"] for e in events]
    n_chunks = math.ceil(SERVE_STEPS / 16)
    if kinds != ["run_start"] + ["steps"] * n_chunks + ["run_end"]:
        raise AssertionError(f"{label}: events {kinds}")
    spans = [(e["name"], e["dur"] / 1e3) for e in tracer.events]
    missing = {"fleet/build", "fleet/compile", "fleet/steady"} - {
        n for n, _ in spans}
    if missing:
        raise AssertionError(f"{label}: spans missing from the trace: "
                             f"{sorted(missing)}")
    t = result.timings
    print(f"{label}: accuracy={result.accuracy:.6f} "
          f"build_s={t['build_s']:.3f} compile_s={t['compile_s']:.3f} "
          f"steady_s={t['steady_s']:.3f} "
          f"camera_steps_per_s={result.camera_steps_per_s:.2f} "
          f"events={len(events)} (all valid) spans_ms="
          + json.dumps({n: round(d, 3) for n, d in spans})
          + f" launches={counts} (over {SERVE_STEPS} steps + 1 warm-up "
          f"step)", flush=True)
    rows[label] = search_phase(rec.calls, steps, f"[{label}]")

    # the same fleet on the 200-cell grid, through the spec API
    grid = OrientationGrid(**BIG_GRID)
    wl = serve_module.DEFAULT_WORKLOAD
    t0 = time.perf_counter()
    video = build_video(grid, SceneConfig(fps=15, seed=3), SERVE["duration"])
    tables = detection_tables(video, wl)
    acc = workload_acc_table(video, wl, tables)
    host_s = time.perf_counter() - t0
    spec = FleetRunSpec.from_objects(
        "tables", n_cameras=N_CAMERAS, grid=grid, workload=wl,
        budget=BudgetConfig(fps=SERVE["fps"]), video=video, tables=tables,
        trace=NetworkTrace.fixed(24.0, 20.0, video.n_frames),
        acc_table=acc)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    with tracing() as tracer, SearchRecorder() as rec:
        result = run_fleet(spec)
    torch.cuda.synchronize()
    counts = _lib.launch_counts()
    label = f"run_fleet tables x{N_CAMERAS} [{grid.n_cells} cells]"
    _launched_only(counts, SEARCH_KERNELS, steps, label)
    paths[label] = counts
    _check_tables_result(result, grid.n_cells, label)
    t = result.timings
    print(f"{label}: substrate (video, teacher tables, accuracy) built on "
          f"the host in {host_s:.1f} s ({video.n_frames} frames x "
          f"{grid.n_cells} cells); accuracy={result.accuracy:.6f} "
          f"build_s={t['build_s']:.3f} (episode tables) "
          f"compile_s={t['compile_s']:.3f} steady_s={t['steady_s']:.3f} "
          f"camera_steps_per_s={result.camera_steps_per_s:.2f} spans_ms="
          + json.dumps({e["name"]: round(e["dur"] / 1e3, 3)
                        for e in tracer.events})
          + f" launches={counts}", flush=True)
    rows[label] = search_phase(rec.calls, steps, f"[{label}]")

    # serve --fleet 4 on the card and on the CPU
    small = dict(fps=2.0, duration=3.0, fleet=4)
    _, card_accs, (on_card,) = _serve(**small)
    _, cpu_accs, (on_cpu,) = _serve(**small, device="cpu")
    same = card_accs == cpu_accs and len(card_accs) == 8 and all(
        torch.equal(getattr(on_card.out, k).cpu(), getattr(on_cpu.out, k))
        for k in ("chosen", "explored", "order", "zooms", "sent"))
    if not same:
        raise AssertionError(f"serve --fleet 4: card and CPU differ: "
                             f"{card_accs} vs {cpu_accs}")
    print(f"serve --fleet 4, small input: card and CPU print the same "
          f"accuracies {card_accs} and decide alike (chosen "
          f"{on_card.chosen})", flush=True)

    # the detector branch: shortlist, distillation, telemetry
    det_events = out_dir / "serve_detector_events.jsonl"
    det_events.unlink(missing_ok=True)
    det_steps = int(SERVE_DETECTOR["duration"] * SERVE_DETECTOR["fps"])
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    with (SearchRecorder() as rec, OracleRecorder() as orec,
          PatchifyRecorder() as prec):
        out, _, (result,) = _serve(**SERVE_DETECTOR,
                                   telemetry=str(det_events))
    torch.cuda.synchronize()
    counts = _lib.launch_counts()
    print(out.rstrip(), flush=True)
    label = (f"serve --fleet {SERVE_DETECTOR['fleet']} [detector, "
             f"shortlist {SHORTLIST_K}, distill]")
    _launched_only(counts, MAIN_PATH_KERNELS, det_steps + 1, label)
    paths[label] = counts
    steps_ev = [e for e in read_events(str(det_events))
                if e["event"] == "steps"]
    if not steps_ev or any(
            len(e["cameras"].get("distill_loss", ())) != result.n_cameras
            for e in steps_ev):
        raise AssertionError(f"{label}: events without distill_loss")
    if result.distill_loss is None or "  distill: " not in out:
        raise AssertionError(f"{label}: no distillation ran")
    print(f"{label}: accuracy={result.accuracy:.6f} distill_loss="
          f"{[round(v, 6) for v in result.distill_loss]} "
          f"launches={counts} (over {det_steps} steps + 1 warm-up step)",
          flush=True)
    oracle_phase(orec.calls, det_steps + 1, f"[{label}]")
    search_phase(rec.calls, det_steps + 1, f"[{label}]")
    patchify_phase(prec.calls, det_steps + 1, f"[{label}]")
    return {"rows": rows, "paths": paths}


def _tree_equal(a, b) -> bool:
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _per_camera_equal(per_camera, shared) -> bool:
    """Every camera's row of `per_camera` bit-equal to `shared`."""
    return all(torch.equal(x, y[None].expand_as(x)) for x, y in zip(
        tree_leaves(per_camera), tree_leaves(shared)))


def distill_phase(spec: FleetRunSpec, frozen_steady_s: float, dev,
                  label: str) -> dict:
    """The learning path: run_fleet with spec.distill and spec.metrics
    at the main path's cell, counters set to 0 just before and read just
    after: oracle_pass, crop_patchify, shape_search and budget_walk once
    per step (the update launches no kernel of its own) and no other;
    every recorded call equal to its plain version; the per-step loss
    finite and >= 0 on updating steps; the learned heads (or networks)
    moved; the backbone (full mode: the patch embedding) bit-unchanged
    against the initial weights, made again from the same seed. Prints
    the run's line; returns its launch counts and timings."""
    steps = spec.n_steps + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    with (SearchRecorder() as rec, OracleRecorder() as orec,
          PatchifyRecorder() as prec):
        result = run_fleet(spec)
    torch.cuda.synchronize()
    counts = _lib.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _launched_only(counts, MAIN_PATH_KERNELS, steps, label)
    chosen = torch.tensor(result.chosen)
    acc = torch.tensor(result.acc_per_step)
    if (chosen.shape != (spec.n_steps, spec.n_cameras)
            or not bool(((chosen >= 0) & (chosen < DEFAULT_GRID.n_cells))
                        .all())
            or not bool(((acc >= 0) & (acc <= 1)).all())):
        raise AssertionError(f"{label}: malformed result {result.chosen} "
                             f"{result.acc_per_step}")
    loss = torch.tensor(result.distill_loss)
    every = spec.distill.every
    upd = torch.tensor([(e + 1) % every == 0 for e in range(spec.n_steps)])
    if not (bool(torch.isfinite(loss).all()) and bool((loss[upd] >= 0).all())
            and bool((loss[~upd] == -1.0).all())):
        raise AssertionError(f"{label}: distill_loss {result.distill_loss}")
    step_loss = result.metrics["distill_loss"]
    if not bool(torch.isfinite(step_loss).all()):
        raise AssertionError(f"{label}: per-camera loss not finite")

    provider, _ = result.learned
    init = detector_init(torch.Generator().manual_seed(0), provider.det_cfg,
                         dev)
    if not _tree_equal(provider.det_params, init):
        raise AssertionError(f"{label}: the shared detector params were "
                             f"written")
    learned = result.learned_params(None)
    if spec.distill.head_only:
        frozen_ok = _tree_equal(learned["backbone"], init["backbone"])
    else:
        frozen_ok = _per_camera_equal(
            learned["backbone"]["vit"]["patch_embed"],
            init["backbone"]["vit"]["patch_embed"])
    moved = not _per_camera_equal(learned["heads"], init["heads"])
    if not frozen_ok:
        raise AssertionError(f"{label}: frozen params changed")
    if not moved:
        raise AssertionError(f"{label}: the learned heads did not move")

    tag = f"[{label}]"
    rows = {"oracle_pass": oracle_phase(orec.calls, steps, tag),
            **search_phase(rec.calls, steps, tag),
            "crop_patchify": patchify_phase(prec.calls, steps, tag)}
    t = result.timings
    ranks = result.metrics["chosen_rank"]
    rank = median_valid_rank(ranks)
    gradable = f"{int((ranks > 0).sum())} of {ranks.numel()}"
    print(f"{label}: accuracy={result.accuracy:.6f} "
          f"frames_sent={list(result.frames_sent)} "
          f"compile_s={t['compile_s']:.3f} steady_s={t['steady_s']:.3f} "
          f"camera_steps_per_s={result.camera_steps_per_s:.2f} "
          f"peak_mem_gib={peak:.2f} (with the recorders' clones of every "
          f"kernel call) "
          f"steady_s/frozen={t['steady_s'] / frozen_steady_s:.3f} "
          f"distill_loss={[round(v, 6) for v in result.distill_loss]} "
          f"chosen_rank_median={rank} (camera-steps gradable: {gradable}; "
          f"a step with fewer than 2 explored cells is not) "
          f"launches={counts} (over "
          f"{spec.n_steps} steps + 1 warm-up step; backbone"
          f"{'' if spec.distill.head_only else ' patch embedding'} "
          f"bit-unchanged, heads moved)", flush=True)
    return dict(counts=counts, timings=t, rows=rows)


def distill_parity_phase() -> None:
    """Small input with learning on: the smoke detector, 2 cameras, 8
    steps, shortlist_k=9, a 3 fps budget (several cells explored per
    step, so chosen_rank is gradable), DistillSpec(), on the card and on
    the CPU:
    the decisions (explored, order, zooms, sent, chosen) equal; the
    per-step loss within 1e-4 relative (float32 convolutions and sums
    in other orders); the learned heads: 98% of elements within 1e-5 and
    every one within 3 lr per update (an AdamW element whose gradient is
    at round-off level steps by up to ~lr either way on either side)."""
    spec = FleetRunSpec(provider="detector", n_cameras=2, n_steps=N_STEPS,
                        shortlist_k=9, budget={"fps": 3.0}, seed=3,
                        distill=DistillSpec(), metrics=MetricsSpec())
    on_card, on_cpu = run_fleet(spec), run_fleet(spec, device="cpu")
    frozen = run_fleet(dataclasses.replace(spec, distill=None))
    for k in ("explored", "order", "zooms", "sent", "chosen"):
        if not torch.equal(getattr(on_card.out, k).cpu(),
                           getattr(on_cpu.out, k)):
            raise AssertionError(f"learning, small input: card vs CPU "
                                 f"{k} differ: {on_card.chosen} vs "
                                 f"{on_cpu.chosen}")
    loss_c = torch.tensor(on_card.distill_loss)
    loss_h = torch.tensor(on_cpu.distill_loss)
    loss_err = float(((loss_c - loss_h).abs() / loss_h.abs()).max())
    if loss_err > 1e-4:
        raise AssertionError(f"learning, small input: loss differs by "
                             f"{loss_err} relative")
    errs = torch.cat([(x.cpu() - y).abs().reshape(-1) for x, y in zip(
        tree_leaves(on_card.learned_params(None)["heads"]),
        tree_leaves(on_cpu.learned_params(None)["heads"]))])
    close = float((errs <= 1e-5).float().mean())
    if close < 0.98 or float(errs.max()) > 3 * DistillSpec().lr * N_STEPS:
        raise AssertionError(f"learning, small input: heads differ "
                             f"({close:.4f} within 1e-5, max "
                             f"{float(errs.max()):.3e})")
    print(f"learning, small input: card and CPU agree (chosen "
          f"{on_card.chosen}; loss max rel err {loss_err:.3e}; heads "
          f"{close:.4f} of elements within 1e-5, max abs err "
          f"{float(errs.max()):.3e}); chosen_rank median on the card "
          f"{median_valid_rank(on_card.metrics['chosen_rank'])} learning, "
          f"{median_valid_rank(frozen.metrics['chosen_rank'])} frozen",
          flush=True)


def vit_flash_phase(spec: FleetRunSpec):
    """The ViT flash path on the main path's own crop_patchify tokens
    (its first step: F cameras x K shortlisted crops): the backbone with
    impl="flash" (counters set to 0 just before, read just after) and
    impl="xla", each through the neck, heads and decode. Returns (row,
    flash detections)."""
    prep = prepare_fleet_run(spec)
    p, st, cfg = prep.provider, prep.state, prep.cfg
    dc = p.det_cfg
    sc, dp = p.init_carry(st)
    dev = prep.device
    kinds = torch.as_tensor(kind_mask(p.scene.spec), device=dev)
    with torch.no_grad():
        sc1, _ = p.scene.oracle(cfg, prep.wl, sc, st)
        noise = render_noise(st.rng, st.step_idx * p.scene.stride,
                             dc.img_res) * p.noise
        tokens, _ = p._shortlist_tokens(cfg, st, sc1, dp, kinds, noise)
        tokens = tokens.reshape((-1,) + tokens.shape[2:])   # [F*K, P, D]
        vp = dp["backbone"]["vit"]

        def backbone(impl):
            return vit_features_tokens(vp, tokens, n_heads=dc.n_heads,
                                       impl=impl)

        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        feats_f = backbone("flash")
        torch.cuda.synchronize()
        counts = _lib.launch_counts()
        if counts["flash_attention"] != dc.n_layers or any(
                v for k, v in counts.items() if k != "flash_attention"):
            raise AssertionError(f"ViT flash path launches {counts}, want "
                                 f"flash_attention x {dc.n_layers} only")
        feats_x = backbone("xla")

        def detect(feats):
            return _decode_detections(dc, *head_outputs(
                dp["heads"], neck_features(dp["backbone"], feats)))

        det_f, det_x = detect(feats_f), detect(feats_x)
        torch.cuda.synchronize()
        # 6 layers of float32 attention summed in another order: 1e-4 on
        # features of order 1 and on scores in [0, 1]; boxes compared
        # where both pick the same cell (a near-tie may swap two cells)
        check_close("vit flash features", (feats_f,), (feats_x,), atol=1e-4)
        check_close("vit flash scores", (det_f.scores,), (det_x.scores,),
                    atol=1e-4)
        box_err = (det_f.boxes - det_x.boxes).abs().amax(-1)
        swapped = int((box_err > 1e-4).sum())
        if swapped > det_f.scores.numel() // 1000:
            raise AssertionError(f"vit flash boxes: {swapped} of "
                                 f"{det_f.scores.numel()} differ")
        ms_f = cuda_ms(lambda: backbone("flash"), 3)
        ms_x = cuda_ms(lambda: backbone("xla"), 3)
    row = dict(launches=counts["flash_attention"],
               feats_err=max_err((feats_f,), (feats_x,)),
               scores_err=max_err((det_f.scores,), (det_x.scores,)),
               boxes_swapped=swapped, backbone_flash_ms=ms_f,
               backbone_xla_ms=ms_x)
    print(f"vit flash path: tokens {tuple(tokens.shape)} "
          f"launches={counts} features max_abs_err={row['feats_err']:.3e} "
          f"scores max_abs_err={row['scores_err']:.3e} "
          f"boxes off by >1e-4: {swapped} of {det_f.scores.numel()} "
          f"backbone ms flash={ms_f:.3f} xla={ms_x:.3f}", flush=True)
    return row, det_f


def kernel_api_phase(dev, dets) -> dict:
    """The kernel APIs driven as a user calls them, counters set to 0
    just before and read just after: box_iou over one step's detections
    of N_BOX_CAMERAS cameras, nms_mask and match_boxes over 8 crops,
    frame_delta over one 1080p frame per camera, rmsnorm at stablelm-3b's
    width. NMS and matching must equal the CPU's; returns the counts."""
    boxes = dets.boxes[:N_BOX_CAMERAS * SHORTLIST_K].reshape(-1, 4)
    crops = dets.boxes[:8].contiguous(), dets.scores[:8].contiguous()
    cur, prev = delta_frames(N_CAMERAS, dev, 4)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(RMS_SHAPE, generator=gen, device=dev)
    wt = torch.ones(RMS_SHAPE[-1], device=dev)

    def nms_and_match(bx, sc):
        keep = [nms_mask(bx[i], sc[i], sc[i] > 0) for i in range(8)]
        match = [match_boxes(bx[i], bx[(i + 1) % 8],
                             sc[(i + 1) % 8] > sc[(i + 1) % 8].median(),
                             iou_thresh=0.3) for i in range(8)]
        return keep, match

    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    iou = box_iou(boxes, boxes)
    keep, match = nms_and_match(*crops)
    deltas = [frame_delta(cur[i], prev[i]) for i in range(N_CAMERAS)]
    y = rmsnorm(x, wt)
    torch.cuda.synchronize()
    counts = _lib.launch_counts()

    want = {"box_iou": 1 + 16, "frame_delta": N_CAMERAS, "rmsnorm": 1}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"kernel API launches {counts}, want {want}")
    keep_c, match_c = nms_and_match(*(t.cpu() for t in crops))
    same = all(torch.equal(a.cpu(), b) for a, b in zip(keep, keep_c))
    same &= all(torch.equal(a.cpu(), b) for m, mc in zip(match, match_c)
                for a, b in zip(m, mc))
    if not same:
        raise AssertionError("nms_mask / match_boxes: card != CPU")
    fd = [check_frame_delta(cur[i], prev[i], *deltas[i][:2],
                            f"frame_delta[{i}]") for i in range(N_CAMERAS)]
    diag = torch.diagonal(iou)[dets.scores[:N_BOX_CAMERAS
                                           * SHORTLIST_K].reshape(-1) > 0]
    sent = torch.stack([d[1].sum() for d in deltas])
    if not (bool(((diag - 1).abs() < 1e-5).all())
            and bool(torch.isfinite(y).all())
            and all(int(d[2]) > 0 for d in deltas)):
        raise AssertionError("kernel API outputs malformed")
    print(f"kernel APIs: launches={counts} boxes={boxes.shape[0]} "
          f"kept per crop={[int(k.sum()) for k in keep]} "
          f"matched per crop={[int(m[0].sum()) for m in match]} "
          f"changed tiles per frame (mean)={float(sent.float().mean()):.1f}"
          f" of {deltas[0][1].numel()}, flipped against the plain version "
          f"{sum(f for _, f in fd)} (max |int8 difference| "
          f"{max(e for e, _ in fd)})", flush=True)

    # after the counted run: box_iou on the same detections (boxes of
    # one image space, so most pairs intersect: the case to judge the
    # kernel by), and nms_mask / match_boxes per call over one crop's 32
    # boxes and over 18 crops' 576
    box_iou_row(boxes, boxes, "one step's detections")
    flat = dets.boxes[:SHORTLIST_K].reshape(-1, 4).contiguous()
    flat_sc = dets.scores[:SHORTLIST_K].reshape(-1).contiguous()
    times = []
    for bx, sc in ((crops[0][0], crops[1][0]), (flat, flat_sc)):
        nv = sc > 0
        nms = cuda_ms(lambda: nms_mask(bx, sc, nv), 3)
        match = cuda_ms(lambda: match_boxes(bx, bx.flip(0), nv,
                                            iou_thresh=0.3), 3)
        times.append(f"N={bx.shape[0]}: nms_mask {nms:.3f} ms, "
                     f"match_boxes {match:.3f} ms")
    print("nms_mask / match_boxes per call (CUDA events, one box_iou "
          "launch + N PyTorch rounds each): " + "; ".join(times),
          flush=True)
    return counts


def stage_phase(spec: FleetRunSpec, dspec: DistillSpec) -> None:
    """Where one step's time goes: the main path's first step, stage by
    stage, with the card synchronised around each (host clock, warm:
    the second of two passes is reported); then the learn stage of that
    step under `dspec` (`learn_stages`)."""
    prep = prepare_fleet_run(spec)
    p, st, cfg, wl = prep.provider, prep.state, prep.cfg, prep.wl
    sc, dp = p.init_carry(st)
    dev = prep.device
    kinds = torch.as_tensor(kind_mask(p.scene.spec), device=dev)
    pair_cls = torch.as_tensor(wl.pair_cls, device=dev)
    res = p.det_cfg.img_res

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        for _ in range(2):
            ms = {}
            # SceneProvider.oracle, in its two parts
            sc1, ms["scene_advance"] = timed(lambda: advance_scene(
                p.scene.spec, p.scene.params, st.rng, sc, st.step_idx,
                p.scene.stride))
            o, ms["oracle"] = timed(lambda: observe_all_cells(
                p.scene.spec, p.scene.teach, p.scene.params, sc1,
                st.step_idx * p.scene.stride, p.scene.windows,
                task_id=wl.task_id, pair_idx=wl.pair_idx,
                n_zoom=len(cfg.zoom_levels), cam_salt=st.rng[:, 0]))
            noise, ms["render_noise"] = timed(lambda: render_noise(
                st.rng, st.step_idx * p.scene.stride, res) * p.noise)
            dets, ms["shortlist_patchify_detector"] = timed(
                lambda: p._score_fused(cfg, st, sc1, dp, kinds, noise))
            do, ms["detections_to_tables"] = timed(
                lambda: detections_obs(dets, p.scene.windows, pair_cls,
                                       p.thresh, p.geo_thresh, o.acc_true,
                                       n_zoom=len(cfg.zoom_levels)))
            obs = FleetObs(*do, mbps=p.scene.mbps[0], rtt=p.scene.rtt[0])
            (st2, out), ms["controller_step"] = timed(
                lambda: fleet_step(cfg, wl, prep.statics, st, obs))
            learn_ms = learn_stages(dspec, prep, sc1, dp, kinds, noise, st,
                                    st2, out, timed)
    total = sum(ms.values())
    syncs = learn_ms.pop("learn_syncs")
    print("stages (ms, one step): " + " ".join(
        f"{k}={v:.3f}" for k, v in {**ms, **learn_ms}.items())
        + f" total={total:.3f} (frozen step) total_with_learn="
        f"{total + learn_ms['learn'] + learn_ms['score_learn_vs_fused']:.3f}"
        f" (learn: head_only={dspec.head_only} {dspec.optimizer}; "
        f"synchronizing calls in one learn hook: {syncs})", flush=True)


def learn_stages(dspec, prep, sc1, dp, kinds, noise, st, st2, out, timed):
    """The learn stage of one step (DistillSpec `dspec`, the same cell
    and inputs as the frozen stages): the scoring through per-camera
    heads that stages the payload (beside the frozen scoring it
    replaces), then the teacher targets of the sent windows, the ring
    harvest and the optimizer update. -> {stage: ms}."""
    p = dataclasses.replace(prep.provider, distill=dspec)
    cfg = prep.cfg
    lc = p.init_carry(prep.state)[2]
    ms = {}
    (_, lc), t_learn = timed(lambda: p._score_learn(cfg, st, sc1, dp, lc,
                                                    kinds, noise))
    _, t_fused = timed(lambda: p._score_fused(cfg, st, sc1, dp, kinds,
                                              noise))
    ms["score_learn_vs_fused"] = t_learn - t_fused
    (sel, ok), ms["learn_select"] = timed(lambda: select_sent_windows(
        out, len(cfg.zoom_levels), dspec.harvest))
    tgt, ms["learn_targets"] = timed(lambda: teacher_window_targets(
        p.scene.spec, p.scene.teach, p.scene.params, sc1,
        (st2.step_idx - 1) * p.scene.stride, p.scene.windows[sel],
        p.det_cfg.max_boxes, st2.rng[:, 0]))
    buf, ms["learn_harvest"] = timed(lambda: harvest_into_buffer(
        lc.buf, lc.staged, lc.staged_widx, sel, ok, *tgt))
    lc = lc._replace(buf=buf)
    _, ms["learn_update"] = timed(lambda: distill_step(dspec, p.det_cfg, lc,
                                                       1))
    ms["learn"] = (ms["learn_select"] + ms["learn_targets"]
                   + ms["learn_harvest"] + ms["learn_update"])

    # the learn hook once more with the card's sync debug mode on: each
    # operation that waits for the device's queue warns once
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            p.learn(cfg, prep.wl, (sc1, dp, lc), st2, out, 0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    ms["learn_syncs"] = sum("synchroniz" in str(w.message) for w in caught)
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _lib.library()
    print(f"build: {_lib.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(_lib.build_log().strip(), flush=True)
    mma = sass_mma_counts(_lib.library_path())
    print(f"tensor-core instructions in the SASS (cuobjdump): "
          f"{json.dumps(mma) if mma else 'not measured (no cuobjdump)'}",
          flush=True)
    if mma:
        idle = [k for k in TENSOR_CORE_KERNELS
                if not (mma.get(k, {}).get("HGMMA") or mma.get(k, {}).get(
                    "HMMA"))]
        if idle:
            raise AssertionError(f"no tensor-core instructions in {idle}")

    rows = kernel_phase(dev)
    rows.update(new_kernel_phase(dev))
    small_parity_phase()
    spec = FleetRunSpec(
        provider="detector", n_cameras=N_CAMERAS, n_steps=N_STEPS,
        shortlist_k=SHORTLIST_K,
        provider_kwargs={"det_cfg": get_config("madeye-approx")})
    main_result, counts, calls, oracle_calls = main_path_phase(spec)
    rows["oracle_pass"] = oracle_phase(oracle_calls)
    rows.update(search_phase(calls))
    frozen_s = main_result.timings["steady_s"]
    del main_result
    # the learning path: head-only (the paper's mode) at the cell's
    # depth; full-param at 3 steps, cut in depth only to keep the
    # script inside its time limit
    distill_phase(dataclasses.replace(spec, distill=DistillSpec(),
                                      metrics=MetricsSpec()),
                  frozen_s, dev, "distill path")
    distill_phase(dataclasses.replace(
        spec, n_steps=FULL_STEPS, distill=DistillSpec(head_only=False),
        metrics=MetricsSpec()), frozen_s * FULL_STEPS / N_STEPS, dev,
        f"distill path, full mode (depth cut to {FULL_STEPS} steps)")
    distill_parity_phase()
    random_search_phase(dev)
    vit_row, dets = vit_flash_phase(spec)
    counts["flash_attention"] = vit_row["launches"]
    api_counts = kernel_api_phase(dev, dets)
    for name in ("box_iou", "frame_delta", "rmsnorm"):
        counts[name] = api_counts[name]
    beyond_limits_phase(dev)
    served = serve_phase(dev)
    stage_phase(spec, DistillSpec())

    kernels = []
    for name, r in rows.items():
        src, replaces = SOURCES[name]
        # launches: the detector main path's; the serving launcher's
        # paths (each counted from 0) and the search kernels' device
        # times on the tables episodes' last steps ride beside them
        served_launches = {label: c[name]
                           for label, c in served["paths"].items()
                           if c[name]}
        tables_graph_ms = {label: rr[name]["graph_ms"]
                           for label, rr in served["rows"].items()
                           if name in rr}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library_ms"),
            **({"graph_ms": r["graph_ms"]} if "graph_ms" in r else {}),
            **({"serve_launches": served_launches}
               if served_launches else {}),
            **({"tables_graph_ms": tables_graph_ms}
               if tables_graph_ms else {})})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
