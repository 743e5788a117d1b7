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

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import rmsnorm_plain

Params = dict


# ---------------------------------------------------------------------------
# initialisation (truncated normals at +-2 std, from a torch.Generator
# or a numpy Generator)
# ---------------------------------------------------------------------------

def trunc_normal(gen, shape, std: float = 0.02,
                 device=None) -> torch.Tensor:
    """Truncated normal draw. A torch.Generator goes through
    torch.nn.init.trunc_normal_, whose draws differ between PyTorch
    versions; a numpy Generator (np.random.default_rng) gives the same
    weights under any PyTorch (standard normals, those past +-2 drawn
    again, times std)."""
    if isinstance(gen, np.random.Generator):
        z = gen.standard_normal(shape)
        out = np.abs(z) > 2.0
        while out.any():
            z[out] = gen.standard_normal(int(out.sum()))
            out = np.abs(z) > 2.0
        return torch.as_tensor((z * std).astype(np.float32), device=device)
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


@contextlib.contextmanager
def full_float32():
    """Within the block, TF32 is off for float32 matrix products and
    cuDNN convolutions (torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32), so the detector runs in full
    float32 on the card, as the model is specified; the flags are
    restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


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


def patch_embed(images: torch.Tensor, wflat: torch.Tensor,
                bias: torch.Tensor | None, *, patch: int) -> torch.Tensor:
    """The conv patch-embed (a patch x patch conv, stride = patch, VALID)
    as a patchify and one matrix product: images [B, H, W, C], wflat
    [patch * patch * C, D] (HWIO weights flattened), bias [D] or None ->
    tokens [B, (H/patch) * (W/patch), D], patches in row-major order.
    The one definition of the embed, shared by `vit_embed` and the plain
    crop -> token stage, so pixels and fused crops embed to equal
    tokens."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    tiles = images[:, :gh * patch, :gw * patch].reshape(
        b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, gh * gw, patch * patch * c)
    tok = torch.matmul(tiles, wflat)
    return tok if bias is None else tok + bias


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
