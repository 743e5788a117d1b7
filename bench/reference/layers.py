"""Plain PyTorch layers of the detector: linear, LayerNorm, the GELU MLP,
the conv patch-embed, SAME-padded NHWC convolutions.

Float32 throughout, with TF32 off (`full_float32`), as the madeye-approx
configuration states. Inside `tf32_products()` every matrix product and
convolution rounds its two operands to TF32 first (10 mantissa bits,
nearest), which is what the card's TF32 mode does to them:
the lower-precision control of the benchmark's comparison. The rounding
passes gradients straight through, so a backward pass still runs.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

Params = dict

_TF32 = {"on": False}


@contextlib.contextmanager
def full_float32():
    """TF32 off for float32 products and cuDNN convolutions inside the
    block; the flags are restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def tf32_products():
    """Every product inside the block takes TF32-rounded operands."""
    saved = _TF32["on"]
    _TF32["on"] = True
    try:
        yield
    finally:
        _TF32["on"] = saved


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with 10 mantissa bits, as the card's
    TF32 conversion gives it (a Veltkamp split by 2^13 + 1; exact ties
    may round the other way), for finite x well inside the float32
    range. Elementwise float operations only, so it maps under vmap."""
    c = x * 8193.0
    return c - (c - x)


def operand(x: torch.Tensor) -> torch.Tensor:
    """x as a product takes it: TF32-rounded inside `tf32_products`, with
    the gradient passed straight through; else x."""
    if not _TF32["on"]:
        return x
    return x + (tf32_round(x.detach()) - x.detach())


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return operand(x) @ operand(w)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, operand(a), operand(b))


def linear(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = torch.square(x - mu).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(p["down"], gelu(linear(p["up"], x)))


def patch_embed(images: torch.Tensor, wflat: torch.Tensor,
                bias: torch.Tensor | None, *, patch: int) -> torch.Tensor:
    """The conv patch-embed (patch x patch, stride = patch, VALID) as a
    patchify and one matrix product: images [B, H, W, C], wflat [patch *
    patch * C, D] (HWIO weights flattened) -> tokens [B, (H/patch) *
    (W/patch), D], patches in row-major order."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    tiles = images[:, :gh * patch, :gw * patch].reshape(
        b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, gh * gw, patch * patch * c)
    tok = matmul(tiles, wflat)
    return tok if bias is None else tok + bias


def _same_pad(size: int, k: int) -> tuple[int, int]:
    total = max(k - 1, 0)
    return total // 2, total - total // 2


def conv2d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME convolution: x [B, H, W, C] (NHWC), p["w"] [kh, kw,
    C, O] (HWIO) -> NHWC."""
    w = p["w"]
    ph, pw = _same_pad(x.shape[1], w.shape[0]), _same_pad(x.shape[2],
                                                         w.shape[1])
    xc = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(operand(xc), operand(w.permute(3, 2, 0, 1)))
    return y.permute(0, 2, 3, 1) + p["b"]


def attention(p: Params, x: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Bidirectional multi-head attention, softmax in float32."""
    b, s, d = x.shape
    dh = d // n_heads
    q, k, v = (linear(p[n], x).reshape(b, s, n_heads, dh)
               for n in ("wq", "wk", "wv"))
    logits = einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(dh))
    o = einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), v)
    return linear(p["wo"], o.reshape(b, s, d))
