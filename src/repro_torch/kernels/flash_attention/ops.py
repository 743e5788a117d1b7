"""Flash attention: plain PyTorch version and the CUDA kernel's wrapper
(csrc/flash_attention.cu), in the model-side layout [B, S, H, D].

`flash_attention(q, k, v)` takes q [B, Sq, Hq, D] and k/v [B, Sk, Hkv, D]
with Hq % Hkv == 0 (GQA: query head h reads kv head h // (Hq / Hkv)) and
returns [B, Sq, Hq, D] in q's dtype. Math is float32 for float32 and
bfloat16 inputs. The kernel reads that layout as it is: no transposes,
no repeated K/V heads and no padding of S or D (the TPU version's
128-lane and block padding), so any S and any D <= 256 go straight in
(past 128, the kernel computes the output in two column slices).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib

MAX_HEAD_DIM = 256
DTYPES = (torch.float32, torch.bfloat16)


def _resolve_scale(scale, d: int) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(d)


def flash_attention_plain(q, k, v, *, causal: bool = False,
                          q_offset: int = 0,
                          scale: float | None = None) -> torch.Tensor:
    """Exact masked softmax attention, same contract as
    `flash_attention`: logits in float32, masked entries -inf (keys past
    the query's position q_offset + i when causal), a row with no
    unmasked key gives 0."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) \
        * _resolve_scale(scale, d)
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]               # [Sq, Sk]
        s = torch.where(mask, s, float("-inf"))
        w = torch.softmax(s, dim=-1)
        w = torch.where(mask.any(-1, keepdim=True), w, 0.0)
    else:
        w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def resident_keys(sk: int, d: int, dtype=torch.float32) -> int:
    """The padded key count the kernel's launcher holds in shared memory
    whole for Sk keys at head dim D (its resident path), or 0 (the tiled
    loop): which path a call of that shape takes on the card."""
    return _lib.library().flash_attention_resident_keys(
        sk, d, int(dtype == torch.bfloat16))


def flash_attention(q, k, v, *, causal: bool = False, q_offset: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] -> [B, Sq, Hq, D]. CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    b, sq, hq, d = q.shape
    if k.dim() != 4 or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"flash_attention: v {tuple(v.shape)} != k "
                         f"{tuple(k.shape)}")
    sk, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads are not a "
                         f"multiple of {hkv} kv heads")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, scale=scale)
    _lib.check_cuda("flash_attention", q, k, v, dtypes=DTYPES)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share a dtype")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    _lib.launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), b, sq, sk, hq, hkv, d,
                _resolve_scale(scale, d), int(causal), q_offset,
                int(q.dtype == torch.bfloat16))
    return out
