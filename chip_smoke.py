"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (every one must pass; the exit code is non-zero otherwise):

  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from src/repro_torch/csrc with nvcc;
  3. hold each kernel against its plain PyTorch version on the card at
     the main path's shapes, and time both with CUDA events;
  4. check the port end to end on a small input: run_fleet on the card
     and on the CPU (plain versions) must make the same decisions;
  5. drive the main path once — run_fleet(provider="detector") at the
     full width of madeye-approx, 64 cameras, 8 steps, shortlist_k=18 —
     with the launch counters set to 0 just before and read just after;
     every kernel must have launched, and the result must be well formed;
  6. time one step of the main path stage by stage;
  7. print one JSON line describing every kernel, the card line again,
     and as the last line {"ok": true, "device": {...}}.

Imports torch and the port (src/repro_torch) only.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import DEFAULT_GRID  # noqa: E402
from repro_torch.fleet.api import (  # noqa: E402
    FleetRunSpec,
    prepare_fleet_run,
    run_fleet,
)
from repro_torch.fleet.state import fleet_statics  # noqa: E402
from repro_torch.fleet.step import FleetObs, fleet_step  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.cell_rasterize.ops import (  # noqa: E402
    cell_rasterize,
    cell_rasterize_plain,
)
from repro_torch.kernels.crop_patchify.ops import (  # noqa: E402
    crop_patchify_batch,
    crop_patchify_plain,
)
from repro_torch.kernels.neighbor_score.ops import (  # noqa: E402
    neighbor_score_batch,
    neighbor_score_plain,
)
from repro_torch.scene.observe import (  # noqa: E402
    detections_obs,
    grid_windows,
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

# the main path's cell: full-width madeye-approx, one step's shapes
N_CAMERAS, N_STEPS, SHORTLIST_K = 64, 8, 18
N_CHANNELS = 8          # 4 workload pairs, student + teacher draws
# the card's published peaks (NVIDIA H100 SXM data sheet: HBM3 bandwidth,
# float32 outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12

SOURCES = {
    "neighbor_score": (
        "src/repro_torch/csrc/neighbor_score.cu",
        "src/repro/kernels/neighbor_score/neighbor_score.py:47"),
    "cell_rasterize": (
        "src/repro_torch/csrc/cell_rasterize.cu",
        "src/repro/kernels/cell_rasterize/cell_rasterize.py:89"),
    "crop_patchify": (
        "src/repro_torch/csrc/crop_patchify.cu",
        "src/repro/kernels/crop_patchify/crop_patchify.py:95"),
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


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
        plain_ms=cuda_ms(lambda: cell_rasterize_plain(*cr_args, **cr_kw),
                         50),
        bound=bound(n_bytes, f * m * c * (25 + 6 * p)))

    # crop_patchify: identical pixels, the 768-term token product summed
    # in another order (explicit FMAs vs torch.matmul) -> 1e-4 absolute
    # on tokens of order 1
    got = (crop_patchify_batch(*cp_args, **cp_kw),)
    want = (crop_patchify_plain(*cp_args, **cp_kw),)
    torch.cuda.synchronize()
    check_close("crop_patchify", got, want, atol=1e-4)
    f, k = cp_args[5].shape[:2]
    res, patch = cp_kw["res"], cp_kw["patch"]
    depth, d = cp_args[7].shape
    gg = (res // patch) ** 2
    n_bytes = 4 * (4 * f * m + 3 * f * m + f * k * 4 + f * res * res * 3
                   + depth * d + d + f * k * gg * d)
    rows["crop_patchify"] = dict(
        max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: crop_patchify_batch(*cp_args, **cp_kw), 10),
        plain_ms=cuda_ms(lambda: crop_patchify_plain(*cp_args, **cp_kw),
                         5),
        bound=bound(n_bytes, 2.0 * f * k * gg * depth * d))
    for name, r in rows.items():
        print(f"kernel {name}: max_abs_err={r['max_abs_err']:.3e} "
              f"ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} "
              f"bound_ms={r['bound'][0]:.6f} ({r['bound'][1]})",
              flush=True)
    return rows


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


def main_path_phase():
    """Drive run_fleet once at the main path's cell; return (result,
    launch counts of that run)."""
    spec = FleetRunSpec(
        provider="detector", n_cameras=N_CAMERAS, n_steps=N_STEPS,
        shortlist_k=SHORTLIST_K,
        provider_kwargs={"det_cfg": get_config("madeye-approx")})
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
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
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    t = result.timings
    print(f"main path: accuracy={result.accuracy:.6f} "
          f"frames_sent={list(result.frames_sent)} "
          f"compile_s={t['compile_s']:.3f} steady_s={t['steady_s']:.3f} "
          f"camera_steps_per_s={result.camera_steps_per_s:.2f} "
          f"peak_mem_gib={peak:.2f} launches={counts} "
          f"(over {N_STEPS} steps + 1 warm-up step)", flush=True)
    return result, counts


def stage_phase(spec: FleetRunSpec) -> None:
    """Where one step's time goes: the main path's first step, stage by
    stage, with the card synchronised around each (host clock, warm:
    the second of two passes is reported)."""
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
            (sc1, o), ms["scene_and_oracle"] = timed(
                lambda: p.scene.oracle(cfg, wl, sc, st))
            noise, ms["render_noise"] = timed(lambda: render_noise(
                st.rng, st.step_idx * p.scene.stride, res) * p.noise)
            dets, ms["shortlist_patchify_detector"] = timed(
                lambda: p._score_fused(cfg, st, sc1, dp, kinds, noise))
            do, ms["detections_to_tables"] = timed(
                lambda: detections_obs(dets, p.scene.windows, pair_cls,
                                       p.thresh, p.geo_thresh, o.acc_true,
                                       n_zoom=len(cfg.zoom_levels)))
            obs = FleetObs(*do, mbps=p.scene.mbps[0], rtt=p.scene.rtt[0])
            _, ms["controller_step"] = timed(
                lambda: fleet_step(cfg, wl, prep.statics, st, obs))
    total = sum(ms.values())
    print("stages (ms, one step): " + " ".join(
        f"{k}={v:.3f}" for k, v in ms.items()) + f" total={total:.3f}",
        flush=True)


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

    rows = kernel_phase(dev)
    small_parity_phase()
    _, counts = main_path_phase()
    stage_phase(FleetRunSpec(
        provider="detector", n_cameras=N_CAMERAS, n_steps=N_STEPS,
        shortlist_k=SHORTLIST_K,
        provider_kwargs={"det_cfg": get_config("madeye-approx")}))

    kernels = []
    for name, r in rows.items():
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
