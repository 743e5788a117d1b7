"""The port's CUDA kernels against their plain PyTorch versions, timed
beside their bounds: the kernel table of PERF.md, one row per line.

    python3 tools/kernel_table.py          # on a CUDA card only

It prints the card's name and power limit, builds the kernels
(`kernels/_lib.py`), counts each kernel's tensor-core instructions
(HGMMA, HMMA) in the library's SASS (failing if a tensor-core kernel has
none), then for every row: the kernel's `max_abs_err` against its plain
version, held to the row's tolerance; `ms`, CUDA events around
back-to-back calls; `graph_ms`, a CUDA graph of them replayed, for
kernels whose device time is near a Python call's dispatch time;
`plain_ms`; `library_ms` where one PyTorch call computes the same
function; and the bound, the larger of the bytes read and written once
over the HBM rate and the operations over the rate of the units that run
them; for flash_attention, the path its launcher took (the keys held
resident, or the tiled loop). The last line is one JSON object with
every row under "kernels".
It exits non-zero if a row is out of its tolerance. Launch counts on the
program's paths are the card tests' (`tests/test_torch_*_cuda.py`).

The search kernels, the oracle pass and crop_patchify are timed on the
inputs of an episode's last step, recorded from a short run_fleet at
each row's configuration (their cost follows the controller's state:
an episode's shapes and budgets, not made-up ones). The standalone
kernels not on the main path take the card tests' seeded inputs
(`tests/torch_kernel_inputs.py`).
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import DEFAULT_GRID, OrientationGrid  # noqa: E402
from repro_torch.core.tradeoff import BudgetConfig  # noqa: E402
from repro_torch.data import SceneConfig, build_video  # noqa: E402
from repro_torch.fleet import step as step_module  # noqa: E402
from repro_torch.fleet.api import FleetRunSpec, run_fleet  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.box_iou.ops import (  # noqa: E402
    box_iou,
    box_iou_plain,
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
from repro_torch.kernels.dense.ops import dense, dense_plain  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
    resident_keys,
)
from repro_torch.kernels.frame_delta.ops import (  # noqa: E402
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
    budget_walk_plain,
    shape_search_plain,
)
from repro_torch.launch.serve import DEFAULT_WORKLOAD  # noqa: E402
from repro_torch.models.detector import (  # noqa: E402
    detector_forward_tokens,
    detector_init,
)
from repro_torch.models.layers import full_float32  # noqa: E402
from repro_torch.scene import observe as observe_module  # noqa: E402
from repro_torch.scene import prng  # noqa: E402
from repro_torch.scene.scene import SceneSpec  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    NetworkTrace,
    detection_tables,
    workload_acc_table,
)
from torch_kernel_inputs import (  # noqa: E402
    GEO,
    clone_tree,
    neighbor_inputs,
    rasterize_inputs,
    t,
)

# the card's published peaks (NVIDIA H100 SXM data sheet: HBM3 bandwidth,
# float32 outside the tensor cores, dense TF32 and bf16 on the tensor
# cores); 32-bit integer operations: 64 INT32 lanes an SM (Hopper white
# paper), 132 SMs at the 1.98 GHz of the float32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12
PEAK_BF16_PER_S = 989e12
PEAK_INT32_PER_S = 132 * 64 * 1.98e9
RATES = {PEAK_FP32_PER_S: "FP32 67 TFLOP/s",
         PEAK_TF32_PER_S: "3xTF32 at 495 TFLOP/s",
         PEAK_BF16_PER_S: "bf16 989 TFLOP/s",
         PEAK_INT32_PER_S: "INT32 16.7 Top/s"}
# float32 products on the tensor cores run in split TF32: three TF32
# products for each float32 one (csrc/wgmma.cuh)
SPLIT_TF32 = 3
# a threefry block function's integer operations: 20 rounds of add,
# rotate and xor, 5 key injections of 3 adds, the key schedule's 2 xors
# and the first 2 adds
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2 + 2
TENSOR_CORE_KERNELS = ("crop_patchify", "flash_attention", "dense")

# the main path's cell: full-width madeye-approx, 64 cameras, 18 windows
# shortlisted a camera, 8 steps after the warm-up; 4 workload pairs,
# student + teacher draws
N_CAMERAS, SHORTLIST_K, N_STEPS, N_CHANNELS = 64, 18, 8, 8
# past the kernels' old limits: the 7.5-degree grid (200 cells, four-word
# cell sets), a 40-slot scene (two ownership words), 16 cameras, 3 steps
BIG_GRID = OrientationGrid(pan_step=7.5, tilt_step=7.5)
BIG_SCENE = SceneSpec(max_people=24, max_cars=16)
BIG_CAMERAS, BIG_STEPS = 16, 3
# swinb-f32-k18's crop_patchify: 32 cameras, Swin-B's 4-pixel patches
# embedded to 128 features
SWIN_CAMERAS, SWIN_PATCH, SWIN_D = 32, 4, 128
# the tables path as `serve --fleet 64` runs it: 5 fps for 20 s over a
# 15 fps video of seed 3, the default network trace (24 Mbps, 20 ms)
SERVE_FPS, SERVE_S, SERVE_SEED = 5.0, 20.0, 3
# box_iou: one step's detections of 16 cameras (16 x 18 crops x 32 boxes)
N_BOX_CAMERAS = 16
FRAME = (1080, 1920, 3)          # frame_delta: one 1080p RGB frame
RMS_SHAPE = (8, 4096, 2560)      # rmsnorm at stablelm-3b's d_model
# dense's rows (M, K, N, act), each with a bias: swinb-f32-k18's stage-3
# fc1 (576 crops x 196 tokens) and stage-4 fc2 (576 x 49: the longest
# K), approx-f256-k18's up-projection, wq and down-projection (4,608
# crops x 197 tokens)
DENSE_SHAPES = {"swinb stage-3 fc1": (112896, 512, 2048, "gelu"),
                "f256 up": (907776, 192, 768, "gelu"),
                "f256 wq": (907776, 192, 192, None),
                "f256 down": (907776, 768, 192, None),
                "swinb stage-4 fc2": (28224, 4096, 1024, None)}

# what each kernel replaces: the JAX package's `pallas_call` site, or
# what runs there instead
REPLACES = {
    # the shape search's loops fused around the neighbor score
    "shape_search": "src/repro/kernels/neighbor_score/neighbor_score.py:47",
    # the reference's shrink-to-budget is an XLA while loop, no Pallas
    "budget_walk": "src/repro/fleet/step.py:207",
    "neighbor_score": "src/repro/kernels/neighbor_score/neighbor_score.py:47",
    "cell_rasterize": "src/repro/kernels/cell_rasterize/cell_rasterize.py:89",
    # the whole oracle pass around the rasterization
    "oracle_pass": "src/repro/kernels/cell_rasterize/cell_rasterize.py:89",
    "crop_patchify": "src/repro/kernels/crop_patchify/crop_patchify.py:95",
    "flash_attention":
        "src/repro/kernels/flash_attention/flash_attention.py:104",
    "box_iou": "src/repro/kernels/box_iou/box_iou.py:49",
    "frame_delta": "src/repro/kernels/frame_delta/frame_delta.py:36",
    "rmsnorm": "src/repro/kernels/rmsnorm/rmsnorm.py:27",
    "threefry": "none: jax.random's threefry, which XLA fuses",
    "dense": "none: the models' dots, left to XLA (layers.py linear)",
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


def max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def check_close(name, got, want, atol, rtol=0.0) -> None:
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


def bit_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: not bit-equal to the plain version")


def bound(n_bytes: float, n_ops: float,
          peak_ops: float = PEAK_FP32_PER_S) -> tuple[float, str, str]:
    """(least ms, "bytes" or "operations", the rate it was taken at)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", "3.35 TB/s"
    return t_ops, "operations", RATES[peak_ops]


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
            name = next((k for k in REPLACES if f"{k}_kernel" in fn), fn)
            counts.setdefault(name, {"HGMMA": 0, "HMMA": 0})
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if f" {op}." in line:
                    counts[name][op] += 1
    return counts


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

# the kernels whose rows time an episode's last call: (module, the name
# its callers look up)
RECORDED = ((observe_module, "oracle_pass"),
            (step_module, "shape_search_batch"),
            (step_module, "budget_walk_batch"),
            (patchify_module, "crop_patchify_batch"))


def detector_spec(n_cameras: int, n_steps: int, shortlist_k: int, *,
                  grid: OrientationGrid = DEFAULT_GRID,
                  scene: SceneSpec | None = None) -> FleetRunSpec:
    """The detector provider at full width (madeye-approx)."""
    kw = {"det_cfg": get_config("madeye-approx")}
    if scene is not None:
        kw["spec"] = scene
    return FleetRunSpec.from_objects(
        "detector", n_cameras=n_cameras, n_steps=n_steps,
        shortlist_k=shortlist_k, grid=grid, **kw)


def tables_spec(grid: OrientationGrid) -> FleetRunSpec:
    """The tables provider of N_CAMERAS cameras over `grid`, as `serve
    --fleet 64` builds it (one shared world: every camera sees the same
    video)."""
    video = build_video(grid, SceneConfig(fps=15, seed=SERVE_SEED), SERVE_S)
    tables = detection_tables(video, DEFAULT_WORKLOAD)
    return FleetRunSpec.from_objects(
        "tables", n_cameras=N_CAMERAS, n_steps=None, seed=SERVE_SEED,
        grid=grid, workload=DEFAULT_WORKLOAD,
        budget=BudgetConfig(fps=SERVE_FPS), video=video, tables=tables,
        trace=NetworkTrace.fixed(24.0, 20.0, video.n_frames),
        acc_table=workload_acc_table(video, DEFAULT_WORKLOAD, tables))


def last_inputs(spec: FleetRunSpec, dev) -> dict:
    """run_fleet(spec) on `dev` -> {name: (args, kwargs)} of the last call
    of each RECORDED kernel the episode made (clones taken before the
    call: the episode updates its state in place)."""
    last, saved = {}, [getattr(m, n) for m, n in RECORDED]

    def keep(name, fn):
        def kept(*args, **kwargs):
            last[name] = clone_tree((args, kwargs))
            return fn(*args, **kwargs)
        return kept

    for (module, name), fn in zip(RECORDED, saved):
        setattr(module, name, keep(name, fn))
    try:
        run_fleet(spec, device=dev)
    finally:
        for (module, name), fn in zip(RECORDED, saved):
            setattr(module, name, fn)
    torch.cuda.synchronize()
    return last


def swin_patchify(cp_args, cp_kw, dev):
    """crop_patchify's inputs at swinb-f32-k18's shape: the first
    SWIN_CAMERAS cameras of a main-path step (their scene, shortlist and
    noisy background) under a He-scaled 4-pixel patch embed to SWIN_D
    features (drawn by numpy, seed 30)."""
    gen = np.random.default_rng(30)
    depth = SWIN_PATCH * SWIN_PATCH * 3
    w = gen.normal(0, math.sqrt(2.0 / depth), (depth, SWIN_D))
    b = gen.normal(0, 0.01, SWIN_D)
    return ((*(x[:SWIN_CAMERAS] for x in cp_args[:7]),
             *(torch.as_tensor(x.astype(np.float32), device=dev)
               for x in (w, b))), dict(cp_kw, patch=SWIN_PATCH))


def step_detections(dev, cp_args, cp_kw):
    """One step's detections of N_BOX_CAMERAS cameras: the main path's
    crop_patchify tokens of those cameras through the full-width
    detector (seed 0, as the fleet's default weights)."""
    tokens = crop_patchify_batch(*cp_args, **cp_kw)[:N_BOX_CAMERAS]
    cfg = get_config("madeye-approx")
    params = detector_init(torch.Generator().manual_seed(0), cfg, dev)
    with torch.no_grad():
        return detector_forward_tokens(
            params, cfg, tokens.reshape((-1,) + tokens.shape[2:]))


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


# ---------------------------------------------------------------------------
# rows
# ---------------------------------------------------------------------------

def row(name: str, label: str, shape: str, tol: str, err: float,
        n_bytes: float, n_ops: float, *, peak=PEAK_FP32_PER_S,
        split: bool = False, run, plain, iters: int, plain_iters: int,
        graph: bool = False, library=None, path: str | None = None) -> dict:
    """One row of the table: the kernel's call `run` and its plain
    version `plain` timed, the bound from bytes and operations (a
    split-TF32 product's at three TF32 operations each); `path`, where a
    kernel has more than one, the one the launcher took."""
    lim = (split_tf32_bound(n_bytes, n_ops) if split
           else bound(n_bytes, n_ops, peak))
    r = {"row": label, "name": name, "shape": shape, "tol": tol,
         "max_abs_err": err, "ms": cuda_ms(run, iters),
         "plain_ms": cuda_ms(plain, plain_iters),
         "library_ms": None if library is None else cuda_ms(library, iters),
         "bound_ms": lim[0], "bound_by": lim[1], "bound_rate": lim[2]}
    if graph:
        r["graph_ms"] = graph_ms(run, iters)
    cu = "shape_search" if name == "budget_walk" else name
    r.update(source=f"src/repro_torch/csrc/{cu}.cu", replaces=REPLACES[name])
    if path is not None:
        r["path"] = path
    graph_s = f" graph_ms={r['graph_ms']:.6f}" if graph else ""
    path_s = f" path={path}" if path is not None else ""
    lib_s = ("null" if r["library_ms"] is None
             else f"{r['library_ms']:.6f}")
    print(f"kernel {label} {name} [{shape}]: max_abs_err={err:.3e} (tol "
          f"{tol}) ms={r['ms']:.6f}{graph_s}{path_s} plain_ms={r['plain_ms']:.6f} "
          f"bound_ms={lim[0]:.6f} ({lim[1]}, {lim[2]}) library_ms={lib_s}",
          flush=True)
    return r


def neighbor_row(ns_args) -> dict:
    # the same formula, the member sum in another order -> 1e-5 relative
    got = (neighbor_score_batch(*ns_args),)
    want = (neighbor_score_plain(*ns_args),)
    check_close("neighbor_score", got, want, atol=1e-5, rtol=1e-5)
    b, n = ns_args[0].shape
    return row("neighbor_score", "1", f"B={b}, N={n}", "1e-5",
               max_err(got, want),
               4 * (3 * b * n + 2 * n * n + 2 * n + b * n), 12 * b * n * n,
               run=lambda: neighbor_score_batch(*ns_args),
               plain=lambda: neighbor_score_plain(*ns_args), iters=200,
               plain_iters=200, graph=True)


def search_rows(label: str, last: dict, what: str) -> list:
    """shape_search and budget_walk on an episode's last call: decisions
    (masks, walk orders, counts) exact, the walk time within 1e-6
    relative (its hop sum in another order). A search that may stop at
    its first test needs no fixed count of operations: the bound is the
    bytes."""
    out = []
    for name, plain, sub in (("shape_search", shape_search_plain, "a"),
                             ("budget_walk", budget_walk_plain, "b")):
        run = getattr(step_module, name + "_batch")
        args, kw = last[name + "_batch"]
        f, n = args[2].shape
        n_bytes = (f * n * (1 + 4 + 8 + 1 + 1) + 8 * f + 9 * n * n + 8 * n
                   if name == "shape_search"
                   else f * n * (1 + 4 + 1 + 8) + 24 * f + 14 * n * n)
        got, want = run(*args, **kw), plain(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for i, (g, w) in enumerate(zip(got, want)):
            if g.dtype == torch.float32:
                check_close(f"{name} [{what}] t", (g,), (w,), atol=0.0,
                            rtol=1e-6)
                err = max(err, float((g - w).abs().max()))
            elif not torch.equal(g, w):
                raise AssertionError(f"{name} [{what}] output {i}: kernel "
                                     f"and plain decide otherwise")
        out.append(row(name, label.replace("*", sub),
                       f"F={f}, N={n}, {what}",
                       "decisions exact, t 1e-6 relative", err, n_bytes,
                       0.0, run=lambda r=run, a=args, k=kw: r(*a, **k),
                       plain=lambda p=plain, a=args, k=kw: p(*a, **k),
                       iters=200, plain_iters=3, graph=True))
    return out


def rasterize_row(cr_args, cr_kw) -> dict:
    # counts exact; areas and moments are float32 sums over objects in
    # another order -> 1e-5 absolute + 1e-5 relative (moments ~1e6 deg^2)
    got = cell_rasterize(*cr_args, **cr_kw)
    want = cell_rasterize_plain(*cr_args, **cr_kw)
    check_close("cell_rasterize.cnt", got[:1], want[:1], atol=0.0)
    check_close("cell_rasterize", got[1:], want[1:], atol=1e-5, rtol=1e-5)
    f, m = cr_args[0].shape
    p = cr_args[4].shape[1]
    c = cr_args[7].shape[0]
    # per (camera, object, window): ~25 geometry ops + ~6 per channel
    return row("cell_rasterize", "2", f"F={f}, M={m}, P={p}, C={c}",
               "counts exact, 1e-5", max_err(got[1:], want[1:]),
               4 * (4 * f * m + f * p * m + 2 * p + 4 * c + 2 * f * p * c
                    + 4 * f * c), f * m * c * (25 + 6 * p),
               run=lambda: cell_rasterize(*cr_args, **cr_kw),
               plain=lambda: cell_rasterize_plain(*cr_args, **cr_kw),
               iters=200, plain_iters=50, graph=True)


def oracle_row(label: str, args, kw) -> dict:
    """counts, nbox and acc_true exact; areas, centroid and extent within
    1e-5 (absolute + relative: float32 sums over objects in another
    order); the spread within 1e-2 as a variance (it cancels: the CPU
    tests' tolerance against the JAX package)."""
    got, want = oracle_pass(*args, **kw), oracle_pass_plain(*args, **kw)
    for name in ("counts", "nbox", "acc_true"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"oracle_pass [{label}]: {name} differs "
                                 f"from the plain version")
    for name in ("areas", "centroid", "extent"):
        check_close(f"oracle_pass [{label}] {name}", (getattr(got, name),),
                    (getattr(want, name),), atol=1e-5, rtol=1e-5)
    check_close(f"oracle_pass [{label}] spread^2", (got.spread ** 2,),
                (want.spread ** 2,), atol=1e-2, rtol=1e-5)
    err = max_err([getattr(got, k) for k in ("areas", "centroid", "extent",
                                              "spread")],
                  [getattr(want, k) for k in ("areas", "centroid", "extent",
                                               "spread")])
    _, teach, _, state, _, windows = args
    f, m = state.oid.shape
    p, c, q = teach.a0.shape[0], windows.shape[0], len(kw["pair_idx"])
    # inputs: pos, size, oid, enabled, t, cam_salt, 4 f32 + 2 i64 teacher
    # rows, windows, the queries; outputs: counts/areas, centroid, spread,
    # extent, acc_true (f32), nbox (i64). Operations: per (camera,
    # object, window) ~25 geometry + ~6 per channel of 2P; per (camera,
    # pair, object) three hashes of ~24
    return row("oracle_pass", label, f"F={f}, M={m}, P={p}, C={c}, Q={q}",
               "counts, nbox, acc_true exact; 1e-5; spread^2 1e-2", err,
               f * m * (8 + 8 + 8 + 1) + 16 * f + p * (16 + 16) + 16 * c
               + 8 * q + f * c * (8 * p + 8 + 12 + 8),
               f * m * c * (25 + 12 * p) + f * p * m * 72,
               run=lambda: oracle_pass(*args, **kw),
               plain=lambda: oracle_pass_plain(*args, **kw), iters=200,
               plain_iters=20, graph=True)


def patchify_row(label: str, cp_args, cp_kw) -> dict:
    """Identical pixels; the patch-token product in split TF32 on the
    tensor cores (~2^-22 relative per term) against torch.matmul's
    float32 -> 1e-4 absolute on tokens of order 1. The bound: the object
    strips, colours, windows, plane and weights read once and the tokens
    written once, against the split-TF32 product."""
    got = (crop_patchify_batch(*cp_args, **cp_kw),)
    want = (crop_patchify_plain(*cp_args, **cp_kw),)
    check_close(f"crop_patchify [{label}]", got, want, atol=1e-4)
    err = max_err(got, want)
    del got, want
    f, m = cp_args[0].shape
    k = cp_args[5].shape[-2]
    res, patch = cp_kw["res"], cp_kw["patch"]
    depth, d = cp_args[7].shape
    gg = (res // patch) ** 2
    return row("crop_patchify", label,
               f"F={f}, K={k}, {res} px, patch {patch}, D={d}, M={m}",
               "1e-4", err,
               4 * (4 * f * m + 3 * f * m + f * k * 4 + f * res * res * 3
                    + depth * d + d + f * k * gg * d),
               2.0 * f * k * gg * depth * d, split=True,
               run=lambda: crop_patchify_batch(*cp_args, **cp_kw),
               plain=lambda: crop_patchify_plain(*cp_args, **cp_kw),
               iters=10, plain_iters=3)


def attn_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """Unmasked (query, key) pairs: what the kernel's work depends on."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i + q_offset + 1)) for i in range(sq))


def flash_row(dev, label: str, b, sq, sk, hq, hkv, d, *, causal=False,
              q_offset=0, dtype=torch.float32, iters=10, plain_iters=3,
              library=False) -> dict:
    """flash_attention against its plain version on seeded N(0, 1)
    inputs (logits of unit scale). float32: split-TF32 products (~2^-22
    relative per term) and the online softmax summed in another order,
    3e-5 on outputs of order 1; bf16: P and the output rounded to bf16,
    2e-2. `library`: PyTorch's SDPA on the same inputs in [B, H, S, D]."""
    gen = torch.Generator(device=dev).manual_seed(sq * 131 + d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                             (b, sk, hkv, d)))
    kw = dict(causal=causal, q_offset=q_offset)
    got = flash_attention(q, k, v, **kw).float()
    want = flash_attention_plain(q, k, v, **kw).float()
    tol = 2e-2 if dtype == torch.bfloat16 else 3e-5
    shape = (f"[{b}, {sq}, {hq}, {d}] kv [{sk}, {hkv}] causal={causal} "
             f"q_offset={q_offset} {str(dtype)[6:]}")
    check_close(f"flash_attention [{shape}]", (got,), (want,), atol=tol,
                rtol=tol)
    err = max_err((got,), (want,))
    del got, want
    lib = None
    if library:
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

        def lib():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)
    es = q.element_size()
    n_ops = 4.0 * b * hq * attn_pairs(sq, sk, causal, q_offset) * d
    keys = resident_keys(sk, d, dtype)
    return row("flash_attention", label, shape, f"{tol:g}", err,
               es * (2 * b * sq * hq * d + 2 * b * sk * hkv * d), n_ops,
               peak=PEAK_BF16_PER_S, split=dtype == torch.float32,
               run=lambda: flash_attention(q, k, v, **kw),
               plain=lambda: flash_attention_plain(q, k, v, **kw),
               iters=iters, plain_iters=plain_iters, library=lib,
               path=f"resident {keys} keys" if keys else "tiled")


def box_iou_row(label: str, a, b, what: str) -> dict:
    """box_iou bit-equal to its plain version (the same float32 ops in
    the same order; a division skipped where inter == 0 is exact); ~13
    operations a pair, the [N, M] output written once."""
    got, want = box_iou(a, b), box_iou_plain(a, b)
    bit_equal(f"box_iou [{what}]", got, want)
    hit = float((got > 0).float().mean())
    del got, want
    n, m = a.shape[0], b.shape[0]
    return row("box_iou", label, f"{n} x {m} {what}, {hit:.3f} of the "
               f"pairs intersect", "bit-equal", 0.0,
               4 * (4 * n + 4 * m + n * m), 13.0 * n * m,
               run=lambda: box_iou(a, b), plain=lambda: box_iou_plain(a, b),
               iters=50, plain_iters=10, graph=True)


def frame_delta_row(dev) -> dict:
    """changed equal but on tiles whose plain mean lies within 1e-6 of
    tau (a sum in another order may flip them); int8 residuals equal
    wherever both sides agree on the tile."""
    cur, prev = (x[0] for x in delta_frames(1, dev, 2))
    dq, changed = frame_delta_tiles(cur, prev)
    dq_p, changed_p = frame_delta_plain(cur, prev)
    h, w, c = FRAME
    d = F.pad(cur - prev, (0, 0, 0, (-w) % 128, 0, (-h) % 16))
    mean = d.abs().reshape(d.shape[0] // 16, 16, d.shape[1] // 128, 128,
                           c).mean(dim=(1, 3, 4))
    agree = changed == changed_p
    if not bool((agree | ((mean - 0.02).abs() < 1e-6)).all()):
        raise AssertionError("frame_delta: changed differs away from tau")
    px = agree.repeat_interleave(16, 0)[:h].repeat_interleave(128, 1)[:, :w]
    if not bool(((dq == dq_p) | ~px[..., None]).all()):
        raise AssertionError("frame_delta: int8 residuals differ")
    err = int((dq.int() - dq_p.int()).abs().max())
    gg = changed.numel()
    return row("frame_delta", "6", f"[{h}, {w}, {c}] f32, "
               f"{int((~agree).sum())} of {gg} tiles flipped",
               "tiles exact but within 1e-6 of tau", float(err),
               h * w * c * (4 + 4 + 1) + 4 * gg, 6.0 * h * w * c,
               run=lambda: frame_delta_tiles(cur, prev),
               plain=lambda: frame_delta_plain(cur, prev), iters=100,
               plain_iters=20, graph=True)


def rmsnorm_row(dev) -> dict:
    # a 2560-term sum of squares in another order and a correctly rounded
    # 1/sqrt against torch.rsqrt -> 1e-5
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(RMS_SHAPE, generator=gen, device=dev)
    wt = torch.randn(RMS_SHAPE[-1], generator=gen, device=dev) + 1.0
    got, want = rmsnorm(x, wt), rmsnorm_plain(x, wt)
    check_close("rmsnorm", (got,), (want,), atol=1e-5, rtol=1e-5)
    err = max_err((got,), (want,))
    del got, want
    return row("rmsnorm", "7", f"{list(RMS_SHAPE)} f32", "1e-5", err,
               4 * (2 * x.numel() + wt.numel()), 4.0 * x.numel(),
               run=lambda: rmsnorm(x, wt),
               plain=lambda: rmsnorm_plain(x, wt), iters=20,
               plain_iters=10,
               library=lambda: F.rms_norm(x, (RMS_SHAPE[-1],), wt,
                                          eps=1e-6))


def threefry_rows(dev) -> list:
    """The render noise [64, 224, 224, 3] and one scene draw (keys
    sliced from split(keys, 8) as the scene step takes them), bit-equal
    to scene/prng.py's plain version; the bytes written once against the
    block function's integer operations. The scene draw takes less
    device time than a Python call takes to dispatch, so its graph_ms is
    the device's time."""
    m = SceneSpec().max_objects
    keys = prng.fold_in_plain(prng.PRNGKey(7, dev),
                              torch.arange(N_CAMERAS, device=dev))
    ks = prng.split_plain(keys, 8)
    res = get_config("madeye-approx").img_res
    out = []
    for label, key, shape, iters, plain_iters in (
            ("8", keys, (res, res, 3), 50, 5),
            ("8 (scene)", ks[:, 1], (m, 2), 200, 50)):
        got, want = prng.normal(key, shape), prng.normal_plain(key, shape)
        bit_equal(f"threefry normal {shape}", got, want)
        n = got.numel()
        del got, want
        out.append(row("threefry", label, f"normal {[N_CAMERAS, *shape]}",
                       "bit-equal", 0.0, 4 * n + 16 * N_CAMERAS,
                       THREEFRY_OPS * n, peak=PEAK_INT32_PER_S,
                       run=lambda k=key, s=shape: prng.normal(k, s),
                       plain=lambda k=key, s=shape: prng.normal_plain(k, s),
                       iters=iters, plain_iters=plain_iters, graph=True))
    return out


def dense_rows(dev) -> list:
    """dense at DENSE_SHAPES against its plain version (cuBLAS's float32
    product, TF32 off, then the bias add and GELU) within 1e-4 absolute
    on outputs of order 1 (split TF32, ~2^-22 relative per term, as
    crop_patchify); `library_ms` torch.matmul + add in float32 (the call
    the port no longer makes)."""
    gen = np.random.default_rng(31)
    out = []
    for what, (m, k, n, act) in DENSE_SHAPES.items():
        x = torch.as_tensor(gen.normal(0, 1, (m, k)).astype(np.float32),
                            device=dev)
        w = torch.as_tensor((gen.normal(0, 1, (k, n)) / math.sqrt(k))
                            .astype(np.float32), device=dev)
        b = torch.as_tensor(gen.normal(0, 0.1, n).astype(np.float32),
                            device=dev)
        got = (dense(x, w, b, act=act),)
        with full_float32():
            want = (dense_plain(x, w, b, act),)
            check_close(f"dense [{what}]", got, want, atol=1e-4)
            err = max_err(got, want)
            del got, want
            out.append(row(
                "dense", "9", f"{what}: M={m} K={k} N={n} act={act}",
                "1e-4", err, 4.0 * (m * k + k * n + n + m * n),
                2.0 * m * k * n, split=True,
                run=lambda: dense(x, w, b, act=act),
                plain=lambda: dense_plain(x, w, b, act), iters=10,
                plain_iters=5, graph=True, library=lambda: x @ w + b))
        del x, w, b
        torch.cuda.empty_cache()
    return out


def table(dev) -> list:
    """Every row of the kernel table, in its order."""
    cfg = get_config("madeye-approx")
    windows = DEFAULT_GRID.n_cells * 3
    main = last_inputs(detector_spec(N_CAMERAS, N_STEPS, SHORTLIST_K), dev)
    big = last_inputs(detector_spec(BIG_CAMERAS, BIG_STEPS, SHORTLIST_K,
                                    grid=BIG_GRID, scene=BIG_SCENE), dev)
    shape, has, cent, _ = neighbor_inputs(N_CAMERAS, 5)
    rows = [neighbor_row((
        torch.as_tensor(shape & has, dtype=torch.float32, device=dev),
        t(cent[..., 0]).to(dev), t(cent[..., 1]).to(dev),
        *(t(GEO[k]).to(dev) for k in ("d_center", "overlap", "cell_x",
                                      "cell_y"))))]
    rows += search_rows("1*", main, "an episode's last step")
    rows += search_rows("1*†", big, "an episode's last step")
    for grid in (DEFAULT_GRID, BIG_GRID):
        rows += search_rows("1*‡", last_inputs(tables_spec(grid), dev),
                            "the tables path's last step, one shared world")
    rows.append(rasterize_row(
        [t(x).to(dev) for x in rasterize_inputs(N_CAMERAS, N_CHANNELS, 6)],
        dict(n_moment=N_CHANNELS // 2)))
    many = last_inputs(FleetRunSpec.from_objects(
        "scene", n_cameras=N_CAMERAS, n_steps=BIG_STEPS,
        spec=SceneSpec(max_people=128, max_cars=128)), dev)
    for label, last in (("2a", main), ("2a†", big), ("2a†", many)):
        rows.append(oracle_row(label, *last["oracle_pass"]))
    del many
    cp_args, cp_kw = main["crop_patchify_batch"]
    rows.append(patchify_row("3", cp_args, cp_kw))
    rows.append(patchify_row("3s", *swin_patchify(cp_args, cp_kw, dev)))
    rows.append(patchify_row("3§", *last_inputs(
        detector_spec(N_CAMERAS, 1, windows), dev)["crop_patchify_batch"]))
    rows.append(patchify_row("3†", *big["crop_patchify_batch"]))
    dets = step_detections(dev, cp_args, cp_kw).boxes.reshape(-1, 4)
    del main, big, cp_args
    torch.cuda.empty_cache()

    # the ViT's layer (64 cameras x 18 crops, 197 tokens, 6 heads of 32,
    # and f256's 256 cameras); stablelm-3b's causal width, GQA with
    # q_offset, bf16; heads past 128 dims (deepseek-v3's MLA at 192, and
    # 256); the LMs' and the ViTs' attention at their serving shapes
    bf16 = torch.bfloat16
    rows += [
        flash_row(dev, "4", N_CAMERAS * SHORTLIST_K, 197, 197, cfg.n_heads,
                  cfg.n_heads, cfg.d_model // cfg.n_heads, iters=20,
                  plain_iters=5, library=True),
        flash_row(dev, "4", 4 * N_CAMERAS * SHORTLIST_K, 197, 197,
                  cfg.n_heads, cfg.n_heads, cfg.d_model // cfg.n_heads,
                  iters=10, plain_iters=2),
        flash_row(dev, "4", 2, 4096, 4096, 32, 32, 80, causal=True,
                  iters=5, plain_iters=2, library=True),
        flash_row(dev, "4", 4, 100, 164, 8, 2, 64, causal=True,
                  q_offset=64),
        flash_row(dev, "4", 64, 256, 256, 8, 8, 64, dtype=bf16)]
    for d in (192, 256):
        for dtype in (torch.float32, bf16):
            rows.append(flash_row(dev, "4†", 2, 1024, 1024, 8, 8, d,
                                  causal=True, dtype=dtype, plain_iters=2,
                                  library=True))
    for label, b, s, h, d in (("4‖", 4, 2064, 32, 80),
                              ("4‖", 2, 512, 128, 192)):
        rows.append(flash_row(dev, label, b, s, s, h, h, d, causal=True,
                              dtype=bf16, library=True))
    for b, s, h, d in ((128, 257, 16, 80), (128, 197, 12, 64)):
        rows.append(flash_row(dev, "4z", b, s, s, h, h, d, dtype=bf16,
                              library=True))
    torch.cuda.empty_cache()

    n = N_BOX_CAMERAS * SHORTLIST_K * 32
    gen = torch.Generator(device=dev).manual_seed(1)

    def boxes():
        return torch.cat([torch.rand((n, 2), generator=gen, device=dev),
                          0.02 + 0.3 * torch.rand((n, 2), generator=gen,
                                                  device=dev)], 1)

    rows.append(box_iou_row("5", boxes(), boxes(), "random boxes"))
    dets = dets.contiguous()
    rows.append(box_iou_row("5†", dets, dets, "one step's detections"))
    rows += [frame_delta_row(dev), rmsnorm_row(dev)]
    return rows + threefry_rows(dev) + dense_rows(dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_table: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _lib.library()
    print(_lib.build_log().strip(), flush=True)
    mma = sass_mma_counts(_lib.library_path())
    print("tensor-core instructions in the SASS (cuobjdump): "
          + (json.dumps(mma) if mma else "not measured (no cuobjdump)"),
          flush=True)
    idle = [k for k in TENSOR_CORE_KERNELS
            if mma and not (mma.get(k, {}).get("HGMMA")
                            or mma.get(k, {}).get("HMMA"))]
    if idle:
        raise AssertionError(f"no tensor-core instructions in {idle}")
    rows = table(dev)
    print(json.dumps({"card": card, "device": torch.cuda.get_device_name(0),
                      "sass_mma": mma, "kernels": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
