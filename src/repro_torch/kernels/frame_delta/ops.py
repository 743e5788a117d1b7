"""Frame-delta encoder (paper §3.3, "Transmitting images"): plain PyTorch
version, the CUDA kernel's wrapper (csrc/frame_delta.cu) with the
bytes-to-send estimate, and the decoder `apply_delta`.

The frame is cut into (tile_h, tile_w, C) tiles, zero-padded up to whole
tiles: a tile is sent when the mean |cur - prev| over the whole padded
tile exceeds tau, as an int8 residual round(clip(d / scale, +-127))
(half to even); unsent tiles carry zeros.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _lib


def _bytes_est(changed: torch.Tensor, tile_h: int, tile_w: int,
               c: int) -> torch.Tensor:
    """changed tiles * tile bytes (int8 payload) + the 1-bit tile map
    + 4 bytes of header."""
    return (changed.sum() * (tile_h * tile_w * c)
            + changed.numel() // 8 + 4)


def frame_delta_plain(cur, prev, *, tile_h: int = 16, tile_w: int = 128,
                      tau: float = 0.02, scale: float = 1.0 / 127.0):
    """cur/prev [H, W, C] -> (delta_q [H, W, C] int8, changed [gh, gw]
    int32), gh = ceil(H / tile_h), gw = ceil(W / tile_w)."""
    h, w, c = cur.shape
    ph, pw = (-h) % tile_h, (-w) % tile_w
    d = cur.float() - prev.float()
    d = F.pad(d, (0, 0, 0, pw, 0, ph))
    gh, gw = d.shape[0] // tile_h, d.shape[1] // tile_w
    tiles = d.reshape(gh, tile_h, gw, tile_w, c).permute(0, 2, 1, 3, 4)
    changed = tiles.abs().mean(dim=(2, 3, 4)) > tau           # [gh, gw]
    # divide by a tensor on d's device: an IEEE division, never the
    # reciprocal product PyTorch may use for a Python scalar divisor
    q = torch.clamp(torch.round(tiles / torch.tensor(scale,
                                                     device=d.device)),
                    -127, 127).to(torch.int8)
    q = torch.where(changed[:, :, None, None, None], q, 0).to(torch.int8)
    delta_q = q.permute(0, 2, 1, 3, 4).reshape(gh * tile_h, gw * tile_w, c)
    return delta_q[:h, :w].contiguous(), changed.to(torch.int32)


def frame_delta_tiles(cur, prev, *, tile_h: int = 16, tile_w: int = 128,
                      tau: float = 0.02, scale: float = 1.0 / 127.0):
    """Same contract as `frame_delta_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if cur.dim() != 3 or prev.shape != cur.shape:
        raise ValueError(f"frame_delta: cur {tuple(cur.shape)} and prev "
                         f"{tuple(prev.shape)} must be one [H, W, C]")
    if cur.device.type == "cpu":
        return frame_delta_plain(cur, prev, tile_h=tile_h, tile_w=tile_w,
                                 tau=tau, scale=scale)
    _lib.check_cuda("frame_delta", cur, prev)
    h, w, c = cur.shape
    dq = torch.empty((h, w, c), dtype=torch.int8, device=cur.device)
    changed = torch.empty((-(-h // tile_h), -(-w // tile_w)),
                          dtype=torch.int32, device=cur.device)
    if dq.numel() == 0:
        return dq, changed.zero_()
    _lib.launch("frame_delta", cur.device, cur.data_ptr(), prev.data_ptr(),
                dq.data_ptr(), changed.data_ptr(), h, w, c, tile_h, tile_w,
                tau, scale)
    return dq, changed


def frame_delta(cur, prev, *, tile_h: int = 16, tile_w: int = 128,
                tau: float = 0.02, scale: float = 1.0 / 127.0):
    """cur/prev [H, W, C] float in [0, 1], any H and W.

    Returns (delta_q [H, W, C] int8, changed [gh, gw] int32, bytes_est
    [] int64)."""
    dq, changed = frame_delta_tiles(cur, prev, tile_h=tile_h, tile_w=tile_w,
                                    tau=tau, scale=scale)
    return dq, changed, _bytes_est(changed, tile_h, tile_w, cur.shape[2])


def apply_delta(prev: torch.Tensor, delta_q: torch.Tensor, *,
                scale: float = 1.0 / 127.0) -> torch.Tensor:
    """Decoder side: cur ~= prev + delta_q * scale."""
    return prev + delta_q.to(torch.float32) * scale
