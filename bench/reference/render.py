"""The crop image model the approximation detector sees: class-colored
object rectangles painted in slot order (last painter wins) over a
textured gradient background plus per-camera render noise, the FOV
projection an axis-aligned crop in scene degrees.

`render_crops_plain` is the one renderer: `render_fleet_crops` (the
unfused detector path's pixels) and the plain version of the fused
crop -> token stage (kernels/crop_patchify) both paint through it, so
the two pipelines see the same pixels. Ownership is resolved with words
of 32 lanes, one lane per object (owner = the highest set bit of the
highest nonzero word of rowbits & colbits), never a [M, res, res] mask
per window; the same owner paints each pixel as in the reference
renderer's masked argmax.
"""
from __future__ import annotations

import torch

from bench.reference import prng
from bench.reference.scene import PERSON

_RENDER_SALT = 0x9E4DE
# (oid * 2654435761) % 97 without the 64-bit product: reduce both factors
# mod 97 first (2654435761 % 97 == 75), exact for any non-negative oid
_SHADE_MULT_97 = 2654435761 % 97

WORD = 32               # object slots per ownership word

_PERSON_COLOR = (0.9, 0.3, 0.2)
_CAR_COLOR = (0.2, 0.4, 0.9)


def render_background(res: int, device=None) -> torch.Tensor:
    """[res, res, 3] textured gradient."""
    a = torch.arange(res, dtype=torch.float32, device=device) / res
    yy, xx = torch.meshgrid(a, a, indexing="ij")
    return torch.stack([0.35 + 0.15 * yy, 0.4 + 0.1 * xx,
                        0.35 + 0.05 * (xx + yy)], dim=-1)


def render_noise(rng: torch.Tensor, frame, res: int) -> torch.Tensor:
    """Per-camera standard-normal noise images [F, res, res, 3] for one
    frame. rng [F, 2] camera keys; the render stream is salted so it
    never collides with the scene-dynamics stream of the same keys."""
    keys = prng.fold_in(prng.fold_in(rng, _RENDER_SALT), frame)
    return prng.normal(keys, (res, res, 3))


def object_colors(kind: torch.Tensor, oid: torch.Tensor) -> torch.Tensor:
    """Per-object paint colors [..., M, 3]: class base color times the
    multiplicative oid shade, in modular arithmetic. kind [M], oid
    [..., M]."""
    shade = 0.7 + 0.3 * ((oid % 97) * _SHADE_MULT_97 % 97) / 97.0
    dev = oid.device
    person = torch.tensor(_PERSON_COLOR, device=dev)
    car = torch.tensor(_CAR_COLOR, device=dev)
    base = torch.where((kind == PERSON)[..., None], person, car)
    return base * shade[..., None]


def render_crops_plain(ox, oy, ow, oh, colors, windows, bgn, *, res: int,
                       min_visible: float) -> torch.Tensor:
    """ox/oy/ow/oh [F, M] boxes; colors [F, M, 3]; windows [F, K, 4] or
    fleet-shared [K, 4]; bgn [F, res, res, 3] background + noise.
    -> crops [F, K, res, res, 3] in [0, 1]."""
    f, m = ox.shape
    if windows.dim() == 2:
        windows = windows[None].expand(f, -1, -1)
    x0 = windows[..., 0][..., None]                  # [F, K, 1]
    y0 = windows[..., 1][..., None]
    fw = windows[..., 2][..., None]
    fh = windows[..., 3][..., None]
    ox0 = (ox - ow / 2)[:, None]                     # [F, 1, M]
    ox1 = (ox + ow / 2)[:, None]
    oy0 = (oy - oh / 2)[:, None]
    oy1 = (oy + oh / 2)[:, None]

    ix0 = torch.maximum(ox0, x0)
    ix1 = torch.minimum(ox1, x0 + fw)
    iy0 = torch.maximum(oy0, y0)
    iy1 = torch.minimum(oy1, y0 + fh)
    inter = (torch.clamp(ix1 - ix0, min=0.0)
             * torch.clamp(iy1 - iy0, min=0.0))
    area = (ox1 - ox0) * (oy1 - oy0)
    keep = inter / torch.clamp(area, min=1e-9) >= min_visible

    # clip first, then truncate (all values non-negative)
    px0 = torch.clamp((ix0 - x0) / fw * res, 0, res - 1).to(torch.int64)
    px1 = torch.clamp((ix1 - x0) / fw * res + 1, 1, res).to(torch.int64)
    py0 = torch.clamp((iy0 - y0) / fh * res, 0, res - 1).to(torch.int64)
    py1 = torch.clamp((iy1 - y0) / fh * res + 1, 1, res).to(torch.int64)

    # objects in words of 32 lanes (slot 32 w + j is bit j of word w),
    # padded slots never painting
    n_w = max(1, -(-m // WORD))
    pad = n_w * WORD - m
    lane = torch.ones(WORD, dtype=torch.int64,
                      device=ox.device) << torch.arange(WORD,
                                                        device=ox.device)
    rc = torch.arange(res, device=ox.device)

    def words(lo, hi):                               # -> [F, K, W, res]
        hit = (keep[..., None] & (rc >= lo[..., None])
               & (rc < hi[..., None]))               # [F, K, M, res]
        hit = torch.nn.functional.pad(hit.to(torch.int64), (0, 0, 0, pad))
        hit = hit.reshape(f, -1, n_w, WORD, res)
        return torch.sum(hit * lane[:, None], dim=-2)

    rowbits, colbits = words(py0, py1), words(px0, px1)
    bits = rowbits[..., :, None] & colbits[..., None, :]   # [F,K,W,r,r]
    # highest set bit: bits = mant * 2**e with mant in [0.5, 1), exact in
    # float64 below 2**53; frexp(0) gives e = 0, so empty words read -1;
    # the owner is the highest set bit of the highest nonzero word
    top = torch.frexp(bits.to(torch.float64)).exponent.to(torch.int64) - 1
    base = WORD * torch.arange(n_w, device=ox.device)
    owner = torch.where(top >= 0, top + base[:, None, None], -1).amax(2)
    cam = torch.arange(f, device=ox.device)[:, None, None, None]
    painted = colors[cam, torch.clamp(owner, min=0)]       # [F,K,r,r,3]
    img = torch.where((owner >= 0)[..., None], painted, bgn[:, None])
    return torch.clamp(img, 0.0, 1.0)


def render_fleet_crops(pos, size, kind, oid, windows, *, res: int = 64,
                       min_visible: float = 0.25,
                       noise: torch.Tensor | None = None) -> torch.Tensor:
    """The whole fleet's candidate-orientation crops in one pass.

    pos/size [F, M, 2], kind [M], oid [F, M], windows [C, 4] fleet-shared
    or [F, C, 4] per camera, noise [F, res, res, 3] or None (one noise
    image per camera, shared across its windows). -> [F, C, res, res, 3]
    in [0, 1]."""
    f = pos.shape[0]
    bgn = render_background(res, pos.device)[None]
    if noise is not None:
        bgn = bgn + noise
    return render_crops_plain(
        pos[..., 0], pos[..., 1], size[..., 0], size[..., 1],
        object_colors(kind, oid).to(torch.float32),
        windows.to(torch.float32), bgn.expand(f, res, res, 3), res=res,
        min_visible=min_visible)


