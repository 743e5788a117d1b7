"""Threefry-2x32 draws in one launch a call: the wrapper of
csrc/threefry.cu. The plain version is scene/prng.py's PyTorch code,
which draws every CPU tensor; scene/prng.py sends each draw on a CUDA
tensor here, with the same signatures and bit-equal results.

Keys are int64 [..., 2] (uint32 words) laid out as they come: leading
dims that walk as one strided row index (contiguous keys, a slice such
as ks[:, 0] of [F, 8, 2], one key broadcast over fold_in's data) go to
the kernel as a row stride; any other layout is copied contiguous
first. Python numbers (uniform's bounds, fold_in's data, randint's
range) travel as kernel arguments, so no call copies from the host.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib

MASK32 = 0xFFFFFFFF
_FOLD_IN, _SPLIT, _BITS, _UNIFORM, _RANDINT, _NORMAL = range(6)


def _check_key(name: str, key) -> None:
    if not isinstance(key, torch.Tensor) or key.dtype != torch.int64:
        raise TypeError(f"threefry {name}: keys must be an int64 tensor, "
                        f"got {getattr(key, 'dtype', type(key).__name__)}")
    if key.dim() < 1 or key.shape[-1] != 2:
        raise ValueError(f"threefry {name}: keys must be [..., 2], got "
                         f"{tuple(key.shape)}")


def _check_device(name: str, key: torch.Tensor, data=None) -> None:
    """After every other check, so each refusal shows without a card."""
    if key.device.type != "cuda":
        raise ValueError(f"threefry {name}: the kernel draws on CUDA "
                         f"tensors, got keys on {key.device} (CPU keys "
                         f"draw through scene/prng.py's plain version)")
    if data is not None and data.device != key.device:
        raise ValueError(f"threefry {name}: data on {data.device}, keys "
                         f"on {key.device}")


def _shape(name: str, shape) -> tuple:
    shape = tuple(int(s) for s in shape)
    if any(s < 0 for s in shape):
        raise ValueError(f"threefry {name}: negative dim in {shape}")
    return shape


def _rows(t: torch.Tensor, batch: tuple, inner: int):
    """(t, elements between rows): t's leading dims (all but its last
    `inner`), broadcast to `batch`, walked as one flat row index. The
    strides as they stand where they allow that, else a contiguous copy
    of t expanded to `batch`."""
    lead = t.shape[:t.dim() - inner]
    pad = len(batch) - len(lead)
    strides = (0,) * pad + tuple(0 if n == 1 else s for n, s in
                                 zip(lead, t.stride()[:len(lead)]))
    row, outer = 0, None
    for n, s in zip(reversed(batch), reversed(strides)):
        if n == 1:
            continue
        if outer is None:
            row = s
        elif s != outer:
            t = t.expand(*batch, *t.shape[t.dim() - inner:]).contiguous()
            return t, math.prod(t.shape[len(batch):])
        outer = s * n
    return t, row


def _draw(name: str, mode: int, key: torch.Tensor, shape, dtype,
          tail: tuple = (), lo: float = 0.0, hi: float = 1.0,
          span: int = 0, mult: int = 0, minval: int = 0) -> torch.Tensor:
    """One launch over the key batch: n = prod(shape) elements a key."""
    shape = _shape(name, shape)
    _check_key(name, key)
    _check_device(name, key)
    batch = tuple(key.shape[:-1])
    out = torch.empty(batch + shape + tail, dtype=dtype, device=key.device)
    if out.numel() == 0:
        return out
    key, row = _rows(key, batch, 1)
    _lib.launch("threefry", key.device, mode, key.data_ptr(), row,
                key.stride(-1), None, 0, 0, out.data_ptr(),
                math.prod(batch), math.prod(shape), lo, hi, span, mult,
                minval)
    return out


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """keys [..., 2] with an int (a kernel argument) or an int64 tensor
    broadcastable against the key batch -> [*batch, 2]."""
    _check_key("fold_in", key)
    if isinstance(data, torch.Tensor):
        if data.dtype != torch.int64:
            raise TypeError(f"threefry fold_in: data must be int64, got "
                            f"{data.dtype}")
        batch = tuple(torch.broadcast_shapes(key.shape[:-1], data.shape))
        _check_device("fold_in", key, data)
        data, data_row = _rows(data, batch, 0)
        ptr, word = data.data_ptr(), 0
    else:
        batch, ptr, data_row = tuple(key.shape[:-1]), None, 0
        word = int(data) & MASK32
        _check_device("fold_in", key)
    out = torch.empty(batch + (2,), dtype=torch.int64, device=key.device)
    if out.numel() == 0:
        return out
    key, row = _rows(key, batch, 1)
    _lib.launch("threefry", key.device, _FOLD_IN, key.data_ptr(), row,
                key.stride(-1), ptr, data_row, word, out.data_ptr(), 1,
                math.prod(batch), 0.0, 1.0, 0, 0, 0)
    return out


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """keys [..., 2] -> [..., num, 2]."""
    return _draw("split", _SPLIT, key, (num,), torch.int64, tail=(2,))


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """keys [..., 2] -> int64 [..., *shape] of 32 random bits."""
    return _draw("random_bits", _BITS, key, shape, torch.int64)


def uniform(key: torch.Tensor, shape: tuple, minval: float,
            maxval: float) -> torch.Tensor:
    """float32 [..., *shape] in [minval, maxval), both Python numbers
    (rounded to float32 as torch.as_tensor rounds them)."""
    return _draw("uniform", _UNIFORM, key, shape, torch.float32,
                 lo=float(minval), hi=float(maxval))


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """int64 [..., *shape] in [minval, maxval) by the double-width
    modulus of the plain version."""
    span = max(int(maxval) - int(minval), 1) & MASK32
    if span == 0:
        raise ValueError(f"threefry randint: maxval - minval = "
                         f"{int(maxval) - int(minval)} is 0 modulo 2**32")
    return _draw("randint", _RANDINT, key, shape, torch.int64, span=span,
                 mult=(2 ** 16 % span) ** 2 % span, minval=int(minval))


def normal(key: torch.Tensor, shape: tuple, lo: float,
           hi: float) -> torch.Tensor:
    """float32 [..., *shape]: sqrt(2) * erfinv(uniform(lo, hi))."""
    return _draw("normal", _NORMAL, key, shape, torch.float32, lo=lo, hi=hi)
