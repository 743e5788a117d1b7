"""The layers the ViT detector uses, as plain functions on parameter
dictionaries (the JAX package's pytree layout, so one checkpoint serves
both): linear, layernorm, rmsnorm, the GELU MLP and the NHWC/HWIO
convolution.

Numerics follow the reference: layernorm uses the population variance
and eps = 1e-6 (torch's default is 1e-5); rmsnorm computes in float32
and returns x's dtype; GELU is the tanh approximation; everything else
is float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import rmsnorm_plain

Params = dict


# ---------------------------------------------------------------------------
# initialisation (truncated normals at +-2 std, from a torch.Generator)
# ---------------------------------------------------------------------------

def trunc_normal(gen: torch.Generator, shape, std: float = 0.02,
                 device=None) -> torch.Tensor:
    x = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(x, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=gen)
    return x.to(device)


def linear_init(gen, d_in: int, d_out: int, *, bias: bool = True,
                device=None) -> Params:
    p = {"w": trunc_normal(gen, (d_in, d_out),
                           std=math.sqrt(1.0 / max(1, d_in)), device=device)}
    if bias:
        p["b"] = torch.zeros(d_out, device=device)
    return p


def conv_init(gen, k_h: int, k_w: int, c_in: int, c_out: int, *,
              device=None) -> Params:
    fan_in = k_h * k_w * c_in
    return {"w": trunc_normal(gen, (k_h, k_w, c_in, c_out),
                              std=math.sqrt(2.0 / max(1, fan_in)),
                              device=device),
            "b": torch.zeros(c_out, device=device)}


def rmsnorm_init(dim: int, *, device=None) -> Params:
    return {"scale": torch.ones(dim, device=device)}


def layernorm_init(dim: int, *, device=None) -> Params:
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm_plain(x, p["scale"], eps)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * p["scale"] + p["bias"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["down"], gelu(linear(p["up"], x)))


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p: Params, x: torch.Tensor, *, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """x [B, H, W, C] (NHWC), p["w"] [kh, kw, C, O] (HWIO) -> NHWC."""
    w = p["w"]
    kh, kw = w.shape[0], w.shape[1]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        ph = _same_pad(x.shape[1], kh, stride)
        pw = _same_pad(x.shape[2], kw, stride)
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"]
    return y
