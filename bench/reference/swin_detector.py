"""The Swin detector, plain PyTorch: a Swin Transformer backbone (Liu et
al., "Swin Transformer: Hierarchical Vision Transformer using Shifted
Windows", arXiv:2103.14030; Swin-B is the official configuration
`configs/swin/swin_base_patch4_window7_224.yaml`) over patch tokens, a
two-level neck, and MadEye's anchor-free heads and decode
(bench/reference/detector.py).

Written from the paper's equations. A stage of depth n at width C runs
n blocks on an H x W map:

  z  = x + W-MSA(LN(x))        (even blocks; odd blocks SW-MSA: the map
  x' = z + MLP(LN(z))           rolled by -s = -w/2 first, back after)

W-MSA is multi-head attention inside each w x w window, heads of width
32, softmax(Q K^T / sqrt(32) + B) V with B the learned relative-position
bias, B[i, j] = table[(dy + w - 1) * (2w - 1) + (dx + w - 1)] for the
offset (dy, dx) from token j to token i. In SW-MSA, tokens of one window
that came from different regions of the unrolled map do not attend to
each other. Where a map is no larger than the window, no block shifts.
Between stages a patch merge concatenates each 2 x 2 neighbourhood (4C),
normalises it and maps it to 2C. The MLP is 4C wide with GELU.

Departures from the published model, each the port's:

  * detection: the paper's detectors put an FPN over all four stages
    under (Cascade) Mask R-CNN; here one level: c3 = LN(stage 3's map)
    and c4 = LN(stage 4's map), p = lateral3(c3) + 2x nearest upsample
    of lateral4(c4), features GELU(smooth(p)), then MadEye's
    anchor-free cls / box / obj heads and top-k decode;
  * the shifted-window mask adds -1e9 across regions, where the
    official code adds -100;
  * LayerNorm epsilon 1e-6, where the official code uses 1e-5;
  * each block's bias table has (2 * 12 - 1)^2 = 529 rows, sized for
    window 12; window 7 reads its first 169 rows;
  * the patch merge concatenates the neighbourhood in row-major order,
    (0, 0), (0, 1), (1, 0), (1, 1), where the official code takes
    (0, 0), (1, 0), (0, 1), (1, 1): a permutation of the reduction's
    input rows;
  * GELU in its tanh form, as the rest of the detector takes it.

Every product goes through bench/reference/layers.py (`linear`,
`conv2d`, `matmul`), so `tf32_products()` rounds its operands.
Parameters: {"backbone": {"swin": {"patch_embed", "patch_norm",
"stages": {"0": {"blocks": {"0": {...}, ...}, "merge"}, ...}, "norm3",
"norm4"}, "neck": {"lateral3", "lateral4", "smooth"}}, "heads"}.
"""
from __future__ import annotations

import torch

from bench.reference.detector import Detections, detections_from_feats
from bench.reference.layers import (
    Params,
    conv2d,
    gelu,
    layernorm,
    linear,
    matmul,
    mlp,
)

HEAD_DIM = 32
TABLE_WINDOW = 12           # the bias tables' rows: (2 * 12 - 1)^2
MASKED = -1e9


def _indexed(node: dict) -> list:
    return [node[str(i)] for i in range(len(node))]


def window_of(side: int, window: int) -> int:
    """The window a map of `side` takes: `window` where it divides the
    map, else the largest divisor of the map up to TABLE_WINDOW."""
    if side % window == 0:
        return window
    return max(w for w in range(1, min(TABLE_WINDOW, side) + 1)
               if side % w == 0)


def relative_index(window: int, device) -> torch.Tensor:
    """[w^2, w^2]: the bias table's row for each (query i, key j) token
    pair of a window, tokens in row-major order."""
    r = torch.arange(window, device=device)
    y = r.repeat_interleave(window)
    x = r.repeat(window)
    dy = y[:, None] - y[None, :] + window - 1
    dx = x[:, None] - x[None, :] + window - 1
    return dy * (2 * window - 1) + dx


def to_windows(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, nW, w^2, C], windows and their tokens in
    row-major order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.transpose(2, 3).reshape(b, -1, window * window, c)


def from_windows(x: torch.Tensor, window: int, h: int, w: int
                 ) -> torch.Tensor:
    b, c = x.shape[0], x.shape[-1]
    x = x.reshape(b, h // window, w // window, window, window, c)
    return x.transpose(2, 3).reshape(b, h, w, c)


def region_mask(h: int, w: int, window: int, shift: int, device
                ) -> torch.Tensor:
    """[nW, w^2, w^2]: 0 between tokens of one region of the rolled map,
    MASKED across regions (the rolled map's last `window` rows hold two
    regions, split `shift` from the end; the same for columns)."""
    def bands(n):
        i = torch.arange(n, device=device)
        return (i >= n - window).long() + (i >= n - shift).long()

    region = bands(h)[:, None] * 3 + bands(w)[None, :]
    win = to_windows(region[None, :, :, None], window)[0, ..., 0]
    same = win[:, :, None] == win[:, None, :]
    zero = torch.zeros((), device=device)
    return torch.where(same, zero, torch.full((), MASKED, device=device))


def window_msa(p: Params, x: torch.Tensor, table: torch.Tensor,
               window: int, mask: torch.Tensor | None) -> torch.Tensor:
    """Multi-head self-attention inside each window: x [B, nW, T, C],
    table [rows, heads], mask [nW, T, T] or None."""
    b, nw, t, c = x.shape
    heads = c // HEAD_DIM

    def split(y):
        return y.reshape(b, nw, t, heads, HEAD_DIM).transpose(2, 3)

    q = split(linear(p["wq"], x))
    k = split(linear(p["wk"], x))
    v = split(linear(p["wv"], x))
    logits = matmul(q, k.transpose(-1, -2)) / HEAD_DIM ** 0.5
    bias = table[relative_index(window, x.device)]        # [T, T, heads]
    logits = logits + bias.permute(2, 0, 1)
    if mask is not None:
        logits = logits + mask[:, None]
    o = matmul(torch.softmax(logits, dim=-1), v)          # [B, nW, H, T, d]
    return linear(p["wo"], o.transpose(2, 3).reshape(b, nw, t, c))


def block(p: Params, x: torch.Tensor, window: int, shift: int
          ) -> torch.Tensor:
    b, h, w, c = x.shape
    y = layernorm(p["norm1"], x)
    if shift:
        y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
    mask = region_mask(h, w, window, shift, x.device) if shift else None
    y = window_msa(p["attn"], to_windows(y, window), p["rel_bias"], window,
                   mask)
    y = from_windows(y, window, h, w)
    if shift:
        y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    x = x + y
    return x + mlp(p["mlp"], layernorm(p["norm2"], x))


def patch_merge(p: Params, x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 2C]."""
    parts = [x[:, dy::2, dx::2] for dy in (0, 1) for dx in (0, 1)]
    return linear(p["reduce"], layernorm(p["norm"], torch.cat(parts, -1)))


def stage_maps(sw: Params, tokens: torch.Tensor, window: int) -> list:
    """Patch tokens [B, P, C] -> each stage's map after its blocks."""
    b, n, c = tokens.shape
    side = round(n ** 0.5)
    x = layernorm(sw["patch_norm"], tokens.reshape(b, side, side, c))
    maps = []
    for st in _indexed(sw["stages"]):
        win = window_of(x.shape[1], window)
        for i, bp in enumerate(_indexed(st["blocks"])):
            shift = win // 2 if i % 2 and x.shape[1] > win else 0
            x = block(bp, x, win, shift)
        maps.append(x)
        if "merge" in st:
            x = patch_merge(st["merge"], x)
    return maps


def neck(nk: Params, c3: torch.Tensor, c4: torch.Tensor) -> torch.Tensor:
    top = conv2d(nk["lateral4"], c4)
    top = top.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    return gelu(conv2d(nk["smooth"], conv2d(nk["lateral3"], c3) + top))


def swin_neck_feats_tokens(params: Params, cfg, tokens: torch.Tensor
                           ) -> torch.Tensor:
    """Patch tokens [B, P, C] -> post-neck map [B, g, g, F]; `cfg` gives
    `window`."""
    sw = params["backbone"]["swin"]
    maps = stage_maps(sw, tokens, cfg.window)
    return neck(params["backbone"]["neck"], layernorm(sw["norm3"], maps[-2]),
                layernorm(sw["norm4"], maps[-1]))


def swin_detector_forward_tokens(params: Params, cfg, tokens: torch.Tensor
                                 ) -> Detections:
    """Patch tokens [B, P, C] -> top-`max_boxes` Detections per crop."""
    return detections_from_feats(
        cfg, params["heads"], swin_neck_feats_tokens(params, cfg, tokens))

