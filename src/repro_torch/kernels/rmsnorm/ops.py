"""Fused RMSNorm: plain PyTorch version and the CUDA kernel's wrapper
(csrc/rmsnorm.cu) for any leading dims, x [..., D] float32 or bfloat16,
float32 math, output in x's dtype."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * weight over the last dim."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., D], weight [D] -> RMS-normalized, same shape and dtype.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (or raise)."""
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)} != ({d},)")
    if x.device.type == "cpu":
        return rmsnorm_plain(x, weight, eps)
    _lib.check_cuda("rmsnorm", x, dtypes=DTYPES)
    _lib.check_cuda("rmsnorm", weight)
    if weight.device != x.device:
        raise ValueError(f"rmsnorm: weight on {weight.device}, x on "
                         f"{x.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    _lib.launch("rmsnorm", x.device, x.data_ptr(), weight.data_ptr(),
                out.data_ptr(), x.numel() // d, d, eps,
                int(x.dtype == torch.bfloat16))
    return out
