"""Operations and bytes from shapes, and the H100's published peaks
(NVIDIA's data sheet, SXM part, dense rates): what the per-layer
metrics divide by. What depends on the model's architecture (a crop's
FLOPs, the heads', the patch embed's sizes) comes from the cell's model
module, `dims["model"]`."""
from __future__ import annotations

PEAK_TF32_FLOPS = 495e12        # dense TF32 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12      # HBM3


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the chip could take: the larger of bytes over the
    bandwidth and operations over the TF32 rate."""
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_TF32_FLOPS)


def step_model_flops(dims: dict) -> float:
    """A step's model work: the configured model's forward over the F x K
    crops and, with distillation on, the head update's forward and
    weight gradient (two head forwards) over each camera's ring of
    pairs."""
    model, s = dims["model"], dims["sizes"]
    flops = dims["n_cameras"] * dims["shortlist_k"] * model.crop_flops(s)
    if dims["distill"] is not None:
        flops += (dims["n_cameras"] * dims["distill"]["buffer"]
                  * 2 * model.head_flops(s))
    return flops


def crop_patchify_cost(dims: dict) -> tuple[float, float]:
    """(bytes, operations) of one crop_patchify launch: the object
    strips and colours, the windows, the background plane, the weights
    read once and the tokens written once; the patch embed's
    multiply-adds (operations counted once, as float32 products), with
    the model's (patch, res, width)."""
    patch, res, d = dims["model"].patch_embed(dims["sizes"])
    f, m, k = dims["n_cameras"], dims["n_objects"], dims["shortlist_k"]
    depth = patch * patch * 3
    gg = (res // patch) ** 2
    n_bytes = 4 * (4 * f * m + 3 * f * m + f * k * 4 + f * res * res * 3
                   + depth * d + d + f * k * gg * d)
    return n_bytes, 2.0 * f * k * gg * depth * d


def oracle_pass_cost(dims: dict) -> tuple[float, float]:
    """(bytes, operations) of one oracle_pass launch: per (camera, object)
    the position, size, id and enabled flag, the teacher rows, windows
    and queries read once, the tables written once; per (camera, object,
    window) ~25 geometry operations and ~6 per channel of 2P, per
    (camera, pair, object) three hashes of ~24 operations."""
    f, m = dims["n_cameras"], dims["n_objects"]
    p, q, c = dims["n_pairs"], dims["n_queries"], dims["n_windows"]
    n_bytes = (f * m * (8 + 8 + 8 + 1) + 16 * f + p * (16 + 16) + 16 * c
               + 8 * q + f * c * (8 * p + 8 + 12 + 8))
    n_ops = f * m * c * (25 + 12 * p) + f * p * m * 72
    return n_bytes, n_ops
