"""Counter-based random numbers: the threefry2x32 key/bit streams the
scene and render draw from, with JAX's `jax_threefry_partitionable=True`
semantics, so the port reproduces the reference's scene streams.

Keys are int64 tensors [..., 2] holding uint32 words; every function
takes a batch of keys (leading dims) and returns that batch in front of
the requested shape. uint32 arithmetic runs in int64 masked to 32 bits
(no product here exceeds 2**63).

Keys, raw bits, `uniform` and `randint` are bit-equal to `jax.random`.
`normal` goes through `erfinv`: this module evaluates the same Giles
polynomial as the reference, but its log1p can round differently in the
last bit, so samples agree to about 1 ulp of erfinv rather than bit for
bit.

Each public function runs the plain PyTorch version below (`*_plain`)
on CPU tensors, and on a CUDA tensor launches the threefry kernel once
(kernels/threefry, csrc/threefry.cu), whose draws are bit-equal to the
plain version's on the card. Under a FakeTensorMode tensors carry no
values, and the plain version gives the shapes.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.threefry import ops as _kernel
from repro_torch.numerics import fma_f32

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK32) | (x >> (32 - d))


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 block function (20 rounds) on broadcastable
    int64 tensors of uint32 values -> (y0, y1)."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x0 = (x0 + k1) & MASK32
    x1 = (x1 + k2) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """Raw key of an integer seed: [0, seed] as uint32 words."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def _plain(key: torch.Tensor) -> torch.Tensor:
    """A key laid out on a mesh (a replicated DTensor) as the plain
    tensor every rank holds: each rank draws the same bits, and DTensor
    has no rule for uniform's reinterpretation of bits as floats."""
    return key.full_tensor() if isinstance(key, DTensor) else key


def _words(key: torch.Tensor, extra_dims: int):
    k1, k2 = key[..., 0], key[..., 1]
    shape = k1.shape + (1,) * extra_dims
    return k1.reshape(shape), k2.reshape(shape)


def _on_card(key: torch.Tensor) -> bool:
    """A CUDA key with values draws through the kernel."""
    return (key.device.type == "cuda" and torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is None)


def fold_in_plain(key: torch.Tensor, data) -> torch.Tensor:
    k1, k2 = key[..., 0], key[..., 1]
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK32
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    k1, k2 = _words(key, 1)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([y0, y1], dim=-1)


def random_bits_plain(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    shape = tuple(shape)
    k1, k2 = _words(key, len(shape))
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return y0 ^ y1


def _scale(floats: torch.Tensor, minval, maxval) -> torch.Tensor:
    """Floats in [0, 1) to [minval, maxval)."""
    dev = floats.device
    lo = torch.as_tensor(minval, dtype=torch.float32, device=dev)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=dev)
    # the reference's compiled program fuses this multiply-add
    return torch.maximum(lo, fma_f32(floats, hi - lo, lo))


def uniform_plain(key: torch.Tensor, shape: tuple, minval=0.0,
                  maxval=1.0) -> torch.Tensor:
    bits = random_bits_plain(key, shape)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return _scale(fbits.view(torch.float32) - 1.0, minval, maxval)


def randint_plain(key: torch.Tensor, shape: tuple, minval: int,
                  maxval: int) -> torch.Tensor:
    keys = split_plain(key, 2)
    higher = random_bits_plain(keys[..., 0, :], shape)
    lower = random_bits_plain(keys[..., 1, :], shape)
    span = max(int(maxval) - int(minval), 1) & MASK32
    mult = (2 ** 16 % span) ** 2 % span
    off = (((higher % span) * mult) & MASK32) + (lower % span)
    return int(minval) + (off & MASK32) % span


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """Mix an integer (or a tensor of integers broadcastable against the
    key batch) into keys [..., 2]."""
    key = _plain(key)
    if not _on_card(key):
        return fold_in_plain(key, data)
    if not isinstance(data, int):
        data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    return _kernel.fold_in(key, data)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """keys [..., 2] -> [..., num, 2]."""
    key = _plain(key)
    if not _on_card(key):
        return split_plain(key, num)
    return _kernel.split(key, num)


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element: keys [..., 2] -> int64 [..., *shape]."""
    key = _plain(key)
    if not _on_card(key):
        return random_bits_plain(key, shape)
    return _kernel.random_bits(key, shape)


def uniform(key: torch.Tensor, shape: tuple, minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """Float32 uniform in [minval, maxval); minval/maxval broadcast
    against `shape` (scalars or tensors). On the card, Python numbers
    go to the kernel as arguments; tensor bounds scale the kernel's
    [0, 1) floats here (the same bits)."""
    key = _plain(key)
    if not _on_card(key):
        return uniform_plain(key, shape, minval, maxval)
    if isinstance(minval, (int, float)) and isinstance(maxval, (int, float)):
        return _kernel.uniform(key, shape, minval, maxval)
    return _scale(_kernel.uniform(key, shape, 0.0, 1.0), minval, maxval)


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """Integers in [minval, maxval) (int64 values, int32 range), by the
    reference's double-width modulus."""
    key = _plain(key)
    if not _on_card(key):
        return randint_plain(key, shape, minval, maxval)
    return _kernel.randint(key, shape, minval, maxval)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# Giles' single-precision erfinv polynomials (w < 5 and w >= 5 branches),
# the approximation XLA evaluates for float32
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """Float32 erfinv by Giles' polynomials with fused multiply-adds in
    the Horner steps. torch.special.erfinv is a different approximation;
    this one tracks the reference's bits far more closely (its log1p
    still differs in the last bit now and then)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, float(np.float32(_ERFINV_LT5[i])),
                           float(np.float32(_ERFINV_GE5[i])))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = fma_f32(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def normal_plain(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    return _SQRT2 * _erfinv(uniform_plain(key, shape, _NORMAL_LO, 1.0))


def normal(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Float32 standard normal: sqrt(2) * erfinv(uniform(-1, 1))."""
    key = _plain(key)
    if not _on_card(key):
        return normal_plain(key, shape)
    return _kernel.normal(key, shape, _NORMAL_LO, 1.0)
