"""Build, load and launch the port's CUDA kernels.

The sources are `repro_torch/csrc/*.cu`, each with a plain C entry point
`<name>_launch(...)` that enqueues the kernel on the given stream and
returns `cudaGetLastError()`. One nvcc call compiles them for Hopper
(sm_90a) into a shared library under `<checkout>/build/repro_torch/`,
named by a hash of the sources and flags so an edited source never
loads a stale build; ctypes loads it at the first launch (nothing is
built or imported at module import, so the CPU tests import freely).

`-fmad=false` keeps nvcc from contracting `a*b + c` into an FMA: the
geometry (visibility cuts, pixel bounds) must round exactly like the
plain PyTorch versions, which run multiply and add as separate ops. The
token product asks for its FMAs explicitly (`__fmaf_rn`). IEEE division
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

SOURCES = ("neighbor_score.cu", "cell_rasterize.cu", "crop_patchify.cu")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v")

KERNELS = ("neighbor_score", "cell_rasterize", "crop_patchify")
LAUNCHES = {name: 0 for name in KERNELS}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # member_has, cent_x, cent_y, d_center, overlap, cell_x, cell_y, out,
    # B, N, stream
    "neighbor_score_launch": [_P] * 8 + [_I, _I, _P],
    # ox, oy, ow, oh, draw, a0, a1, windows, cnt, area, wcx, wcy, wc2,
    # ext, B, M, P, C, n_moment, min_visible, stream
    "cell_rasterize_launch": [_P] * 14 + [_I] * 5 + [_F, _P],
    # ox, oy, ow, oh, colors, windows, bgn, w, b, out, F, M, K,
    # per_camera_windows, res, patch, D, min_visible, stream
    "crop_patchify_launch": [_P] * 10 + [_I] * 7 + [_F, _P],
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + ("common.cuh",):
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels (once per source hash); returns the .so path.
    The compiler's register/spill report is kept in `build_log()`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _state["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{_state['log']}")
    out.with_suffix(".log").write_text(_state["log"])
    os.replace(tmp, out)
    return out


def build_log() -> str:
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


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Device, dtype and layout checks before handing pointers to a
    kernel: float32, one CUDA device, C-contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
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
