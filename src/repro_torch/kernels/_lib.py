"""Build, load and launch the port's CUDA kernels.

The sources are `repro_torch/csrc/*.cu`, each with a plain C entry point
`<name>_launch(...)` that enqueues the kernel on the given stream and
returns `cudaGetLastError()`. nvcc compiles them for Hopper (sm_90a),
one process per source started together, and links the objects into one
shared library under `<checkout>/build/repro_torch/`, named by a hash of
the sources and flags so an edited source never loads a stale build;
ctypes loads it at the first launch (nothing is built or imported at
module import, so the CPU tests import freely).

`-fmad=false` keeps nvcc from contracting `a*b + c` into an FMA: the
geometry (visibility cuts, pixel bounds) must round exactly like the
plain PyTorch versions, which run multiply and add as separate ops. The
products ask for their FMAs explicitly (`__fmaf_rn`) or run on the
tensor cores (`wgmma`, which the flag does not touch). IEEE division
and square root stay on (no fast math).

Each wrapper counts its launches in `LAUNCHES`, so a run can show that
its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCES = ("neighbor_score.cu", "shape_search.cu", "cell_rasterize.cu",
           "oracle_pass.cu", "crop_patchify.cu", "flash_attention.cu",
           "box_iou.cu", "frame_delta.cu", "rmsnorm.cu", "threefry.cu",
           "dense.cu")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

KERNELS = ("neighbor_score", "shape_search", "budget_walk",
           "cell_rasterize", "oracle_pass", "crop_patchify",
           "flash_attention", "box_iou", "frame_delta", "rmsnorm",
           "threefry", "dense")
LAUNCHES = {name: 0 for name in KERNELS}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _U = ctypes.c_longlong, ctypes.c_uint32
_SIGNATURES = {
    # member_has, cent_x, cent_y, d_center, overlap, cell_x, cell_y, out,
    # B, N, stream
    "neighbor_score_launch": [_P] * 8 + [_I, _I, _P],
    # prev, labels, centroids, has_boxes, max_cells, d_center, overlap,
    # cell_x, cell_y, neighbor8, out, F, N, base_threshold,
    # threshold_growth, max_swaps, stream
    "shape_search_launch": [_P] * 11 + [_I, _I, _F, _F, _I, _P],
    # mask, start, labels, budget_s, dist, mst_adj, nbr_order, neighbor8,
    # out_mask, order, cnt, t, F, N, per_cell, rotation_speed, stream
    "budget_walk_launch": [_P] * 12 + [_I, _I, _F, _F, _P],
    # ox, oy, ow, oh, draw, a0, a1, windows, cnt, area, wcx, wcy, wc2,
    # ext, B, M, P, C, n_moment, min_visible, stream
    "cell_rasterize_launch": [_P] * 14 + [_I] * 5 + [_F, _P],
    # pos, size, oid, enabled, t, cam_salt, a0, a1, pmax, flicker, cls,
    # salt, windows, queries (host [2, Q] int32), counts, areas,
    # centroid, spread, extent, nbox, acc_true, F, M, P, C, Q,
    # salt_stride, max_people, flicker_bucket, base_salt, miss_salt,
    # min_visible, miss_rate, stream
    "oracle_pass_launch": [_P] * 21 + [_I] * 10 + [_F] * 2 + [_P],
    # ox, oy, ow, oh, colors, windows, bgn, w, b, out, F, M, K,
    # per_camera_windows, res, patch, D, min_visible, stream
    "crop_patchify_launch": [_P] * 10 + [_I] * 7 + [_F, _P],
    # q, k, v, out, B, Sq, Sk, Hq, Hkv, D, scale, causal, q_offset,
    # is_bf16, stream
    "flash_attention_launch": [_P] * 4 + [_I] * 6 + [_F] + [_I] * 3 + [_P],
    # Sk, D, is_bf16 -> the keys held resident (0: the tiled loop)
    "flash_attention_resident_keys": [_I] * 3,
    # a, b, out, N, M, stream
    "box_iou_launch": [_P] * 3 + [_I] * 2 + [_P],
    # cur, prev, delta_q, changed, H, W, C, tile_h, tile_w, tau, scale,
    # stream
    "frame_delta_launch": [_P] * 4 + [_I] * 5 + [_F] * 2 + [_P],
    # x, weight, out, T, D, eps, is_bf16, stream
    "rmsnorm_launch": [_P] * 3 + [_I] * 2 + [_F, _I, _P],
    # mode, key, key_row, key_word, data, data_row, data_word, out, rows,
    # n, lo, hi, span, mult, minval, stream
    "threefry_launch": [_I, _P, _L, _L, _P, _L, _U, _P, _L, _L, _F, _F, _U,
                        _U, _L, _P],
    # x, w, bias (or null), wsplit, out, M, K, N, n_tile, gelu, vec,
    # stream
    "dense_launch": [_P] * 5 + [_L] + [_I] * 5 + [_P],
}

_state: dict = {"lib": None, "path": None, "log": ""}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def library_path() -> Path:
    """The build's path, named by a hash of the flags and of every source
    and header under csrc/ (an edited header must not load a stale
    build)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list) -> str:
    """Run the commands concurrently; return their joined output, or
    raise with it if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        text = proc.communicate()[0]
        logs.append(text)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode})")
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}\n{log}")
    return log


def build() -> Path:
    """Compile the kernels (once per source hash): one nvcc per source,
    all started together, then one link. Returns the .so path. The
    compiler's register/spill report is kept in `build_log()`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    log = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                     str(CSRC / s)] for s, o in zip(SOURCES, objs)])
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    log += _run_all([[_nvcc(), "-shared", "-o", str(tmp),
                      *(str(o) for o in objs)]])
    _state["log"] = log
    for o in objs:
        o.unlink()
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """The compiler's output (registers, spills) of this build: kept
    beside the library, so a build made by an earlier process reports
    it too."""
    saved = library_path().with_suffix(".log")
    if not _state["log"] and saved.exists():
        _state["log"] = saved.read_text()
    return _state["log"]


def library() -> ctypes.CDLL:
    if _state["lib"] is None:
        path = build()
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [_I]
        lib.repro_error_string.restype = ctypes.c_char_p
        _state["lib"], _state["path"] = lib, path
    return _state["lib"]


def check_cuda(name: str, *tensors: torch.Tensor,
               dtypes=(torch.float32,)) -> None:
    """Device, dtype and layout checks before handing pointers to a
    kernel: one of `dtypes` (float32 by default), one CUDA device,
    C-contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name}: expected {dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def launch(name: str, device: torch.device, *args) -> None:
    """Call `<name>_launch(*args, stream)` on the current stream of
    `device`; raise if the launch was refused; count it."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{name}_launch")(*args, stream)
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    LAUNCHES[name] += 1
