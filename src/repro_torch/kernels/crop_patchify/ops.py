"""Candidate crops -> ViT patch-embedding tokens: plain PyTorch version,
the CUDA kernel's wrapper (csrc/crop_patchify.cu) and the
provider-native entry `crop_patchify`.

The plain version composes the two stages the kernel fuses: render every
(camera, window) crop with the one renderer (scene/render
.render_crops_plain: last-painter-wins ownership in words of 32 lanes),
then apply the conv patch-embed (stride = patch, VALID) as a patchify +
matrix product (models/layers.patch_embed, the computation vit_embed
makes on images, so the unfused detector path's tokens are these
tokens). The kernel paints the same pixels tile by tile and never
writes them to device memory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.models.layers import patch_embed
from repro_torch.scene.render import (
    WORD,
    object_colors,
    render_background,
    render_crops_plain,
)

MAX_WORDS = 8           # the kernel's ownership words: up to 256 slots
MAX_OBJECTS = WORD * MAX_WORDS
K_CHUNK = 64            # the kernel's K depth per ring stage
SMEM_LIMIT = 232448     # a block's opt-in shared memory on the H100


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), as the card's cvt.rna.tf32.f32 gives it, for finite x."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x = hi + lo (to ~2^-22 relative) with hi = tf32(x) and
    lo = tf32(x - hi): the operands of the kernel's split-TF32 product."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def n_tile(d: int) -> int:
    """The kernel's feature tile: all D features in one block (64 for
    D <= 64, else 192 per tile)."""
    return 64 if d <= 64 else 192


def n_words(m: int) -> int:
    """The kernel's ownership words for M object slots (1, 2, 4 or 8)."""
    return next(w for w in (1, 2, 4, 8) if m <= WORD * w)


def kernel_shared_bytes(m: int, res: int, patch: int, d: int,
                        n_crops: int) -> int:
    """The kernel's dynamic shared memory per block (csrc/
    crop_patchify.cu, shared_bytes): the 2-stage weight ring and K table,
    then per crop a 128-row tile touches its row and column masks and
    its objects' packed bounds and (up to 4 words) colours."""
    w = n_words(m)
    n_cmax = min(127 // (res // patch) ** 2 + 2, n_crops)
    per_crop = 2 * res * w * 4 + WORD * w * (2 + (3 if w <= 4 else 0)) * 4
    return 2 * 2 * n_tile(d) * K_CHUNK * 4 + 2 * K_CHUNK * 16 + (
        n_cmax * per_crop)


def tf32_split_weights(wflat: torch.Tensor) -> torch.Tensor:
    """[p*p*3, D] weights -> hi and lo halves in the order the kernel's
    wgmma reads them: [D tiles][K chunks][hi, lo][NT/8][K_CHUNK/4][8][4],
    K-major 8 x 4 core matrices, zero past D and p*p*3 (csrc/
    crop_patchify.cu streams one K chunk of both halves as one block)."""
    depth, d = wflat.shape
    nt = n_tile(d)
    n_dt = -(-d // nt)
    n_kc = -(-depth // K_CHUNK)
    wt = torch.zeros((n_dt * nt, n_kc * K_CHUNK), dtype=torch.float32,
                     device=wflat.device)
    wt[:d, :depth] = wflat.t()
    halves = torch.stack(tf32_split(wt))              # [2, N, K]
    return halves.reshape(2, n_dt, nt // 8, 8, n_kc, K_CHUNK // 4,
                          4).permute(1, 4, 0, 2, 5, 3, 6).contiguous()


def crop_patchify_plain(ox, oy, ow, oh, colors, windows, bgn, wflat, bias,
                        *, res: int, patch: int,
                        min_visible: float) -> torch.Tensor:
    """Render (scene/render.render_crops_plain) + the conv patch-embed
    (models/layers.patch_embed, as vit_embed computes it). wflat
    [p*p*3, D] (HWIO weights flattened), bias [D] -> tokens [F, K,
    (res/p)^2, D]."""
    crops = render_crops_plain(ox, oy, ow, oh, colors, windows, bgn,
                               res=res, min_visible=min_visible)
    f, k = crops.shape[:2]
    tok = patch_embed(crops.reshape((f * k,) + crops.shape[2:]), wflat,
                      bias, patch=patch)
    return tok.reshape((f, k) + tok.shape[1:])


def crop_patchify_batch(ox, oy, ow, oh, colors, windows, bgn, wflat,
                         bias, *, res: int, patch: int,
                         min_visible: float) -> torch.Tensor:
    """Same contract as `crop_patchify_plain`. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    if ox.device.type == "cpu":
        return crop_patchify_plain(ox, oy, ow, oh, colors, windows, bgn,
                                   wflat, bias, res=res, patch=patch,
                                   min_visible=min_visible)
    ins = (ox, oy, ow, oh, colors, windows, bgn, wflat, bias)
    _lib.check_cuda("crop_patchify", *ins)
    f, m = ox.shape
    per_camera = windows.dim() == 3
    k = windows.shape[-2]
    d = wflat.shape[1]
    if any(t.shape != (f, m) for t in (oy, ow, oh)):
        raise ValueError("crop_patchify: object strips must be [F, M]")
    if colors.shape != (f, m, 3):
        raise ValueError("crop_patchify: colors must be [F, M, 3]")
    if windows.shape != ((f, k, 4) if per_camera else (k, 4)):
        raise ValueError("crop_patchify: windows must be [F, K, 4] or "
                         "[K, 4]")
    if bgn.shape != (f, res, res, 3):
        raise ValueError("crop_patchify: bgn must be [F, res, res, 3]")
    if wflat.shape != (patch * patch * 3, d) or bias.shape != (d,):
        raise ValueError("crop_patchify: weights must be [p*p*3, D], "
                         "bias [D]")
    if m > MAX_OBJECTS or res % patch or res > 1024:
        raise ValueError(f"crop_patchify kernel takes M <= {MAX_OBJECTS} "
                         f"objects and res <= 1024 divisible by patch; got "
                         f"M={m}, res={res}, patch={patch}")
    smem = kernel_shared_bytes(m, res, patch, d, f * k)
    if smem > SMEM_LIMIT:
        raise ValueError(f"crop_patchify kernel needs {smem} bytes of "
                         f"shared memory per block at M={m}, res={res}, "
                         f"patch={patch}, D={d}: over the {SMEM_LIMIT}-"
                         f"byte budget")
    g = res // patch
    out = torch.empty((f, k, g * g, d), dtype=torch.float32,
                      device=ox.device)
    if out.numel() == 0:
        return out
    wsplit = tf32_split_weights(wflat)
    ins = ins[:7] + (wsplit, bias)
    _lib.launch("crop_patchify", ox.device, *(t.data_ptr() for t in ins),
                out.data_ptr(), f, m, k, int(per_camera), res, patch, d,
                float(min_visible))
    return out


def crop_patchify(pos, size, kind, oid, windows, patch_params, *,
                  patch: int, res: int, min_visible: float = 0.25,
                  noise=None, block_k: int | None = None) -> torch.Tensor:
    """pos/size [F, M, 2], kind [M], oid [F, M]; windows [F, K, 4] or
    [K, 4] fleet-shared; patch_params {"w": [p, p, 3, D], "b": [D]} (the
    conv patch-embed, HWIO); noise [F, res, res, 3] or None.
    -> tokens [F, K, (res/p)^2, D].

    `block_k` (plain version only; must divide K) renders the window axis
    in slabs so the transient pixel buffer peaks at [F, block_k, res,
    res, 3]; the kernel never materializes pixels and ignores it."""
    if res % patch != 0:
        raise ValueError(f"res={res} must be a multiple of patch={patch}")
    k = windows.shape[-2]
    if block_k is not None and (block_k <= 0 or k % block_k != 0):
        raise ValueError(f"block_k={block_k} must divide the {k} windows")
    dev = pos.device
    colors = object_colors(kind, oid).to(torch.float32).contiguous()
    bgn = render_background(res, dev)[None]
    if noise is not None:
        bgn = bgn + noise
    bgn = bgn.expand(pos.shape[0], res, res, 3).contiguous()
    wflat = patch_params["w"].to(torch.float32).reshape(
        patch * patch * 3, -1).contiguous()
    bias = patch_params.get("b")
    bias = (torch.zeros(wflat.shape[1], device=dev) if bias is None
            else bias.to(torch.float32).contiguous())
    strips = [x.contiguous() for x in (pos[..., 0], pos[..., 1],
                                       size[..., 0], size[..., 1])]
    windows = windows.to(torch.float32).contiguous()

    def run(w):
        return crop_patchify_batch(*strips, colors, w, bgn, wflat, bias,
                                    res=res, patch=patch,
                                    min_visible=min_visible)

    if dev.type != "cpu" or block_k is None or block_k >= k:
        return run(windows)
    return torch.cat([run(windows[..., s:s + block_k, :].contiguous())
                      for s in range(0, k, block_k)], dim=1)
