"""y = act(x @ w + b), float32: the plain PyTorch version and the CUDA
kernel's wrapper (csrc/dense.cu), for x [..., K], w [K, N], b [N] or
None, and act None (the identity) or "gelu" (the tanh GELU, as
models/layers.gelu). models/layers.linear launches it for plain float32
CUDA tensors whose result needs no gradient, in products of at least
layers.DENSE_MIN_ROWS rows and layers.DENSE_MIN_MACS multiply-adds.

The kernel runs the product on the tensor cores in split TF32 (three
TF32 products per k-step, float32-class accuracy), with the bias and
the GELU in its epilogue. One call is two launches on the stream: a
pre-pass that rounds w into TF32 halves laid out as the product reads
them, into a buffer that lives for the call (no copy of the weights is
kept), then the product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _lib

K_CHUNK = 16                     # the kernel's K depth per ring stage
N_TILES = (64, 96, 128)          # its output tile widths
ACTS = (None, "gelu")


def n_tile(n: int) -> int:
    """The N tile the kernel takes for N columns: the fewest padded
    columns, then the widest tile (the fewest passes over x): two of 96
    for the ViT's 192, 128 for 128-4,096."""
    return min(N_TILES, key=lambda t: (-(-n // t) * t, -t))


def split_floats(k: int, n: int) -> int:
    """The pre-pass's buffer, in floats: both TF32 halves of w, padded to
    whole N tiles and K chunks."""
    nt = n_tile(n)
    return 2 * (-(-n // nt) * nt) * (-(-k // K_CHUNK) * K_CHUNK)


def dense_plain(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor | None = None,
                act: str | None = None) -> torch.Tensor:
    y = x @ w
    if b is not None:
        y = y + b
    return F.gelu(y, approximate="tanh") if act == "gelu" else y


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
          *, act: str | None = None) -> torch.Tensor:
    """Same contract as `dense_plain`. CPU tensors take the plain version;
    CUDA tensors launch the kernel, or raise for what it does not take
    (another dtype than float32, tensors on two devices, non-contiguous
    tensors, shapes that do not chain)."""
    if act not in ACTS:
        raise ValueError(f"dense: act must be one of {ACTS}, got {act!r}")
    if x.device.type == "cpu":
        return dense_plain(x, w, b, act)
    ins = (x, w) if b is None else (x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"dense: expected CUDA or CPU tensors, got "
                         f"{x.device}")
    _lib.check_cuda("dense", *ins)
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"dense: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    k, n = w.shape
    if n == 0 or (b is not None and b.shape != (n,)):
        raise ValueError(f"dense: w {tuple(w.shape)} and b "
                         f"{None if b is None else tuple(b.shape)}")
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    wsplit = torch.empty(split_floats(k, n), dtype=torch.float32,
                         device=x.device)
    vec = k % 4 == 0 and x.data_ptr() % 16 == 0
    _lib.launch("dense", x.device, x.data_ptr(), w.data_ptr(),
                None if b is None else b.data_ptr(), wsplit.data_ptr(),
                out.data_ptr(), out.numel() // n, k, n, n_tile(n),
                int(act == "gelu"), int(vec))
    return out
