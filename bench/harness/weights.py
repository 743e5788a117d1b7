"""The detector's weights, made on the device from the seed in one draw:
truncated normals (cut at two standard deviations) scaled per leaf, He
for convolutions, LeCun for linears, 0.02 for the CLS and position
tokens; zero biases, unit LayerNorm scales. The layout is the nested
dictionary the detector takes (ViT layers stacked on a leading axis)."""
from __future__ import annotations

import math

import torch


def _shapes(s) -> dict:
    """leaf path -> (shape, std); std None: zeros, "one": ones."""
    d, L, ff, f, p = s.d_model, s.n_layers, s.d_ff, s.fpn_dim, s.patch
    gg = (s.img_res // p) ** 2

    def lin(pre, a, b, stack=True):
        lead = (L,) if stack else ()
        return {f"{pre}/w": (lead + (a, b), math.sqrt(1.0 / a)),
                f"{pre}/b": (lead + (b,), None)}

    def conv(pre, k, a, b):
        return {f"{pre}/w": ((k, k, a, b), math.sqrt(2.0 / (k * k * a))),
                f"{pre}/b": ((b,), None)}

    def norm(pre, stack=True):
        lead = (L,) if stack else ()
        return {f"{pre}/scale": (lead + (d,), "one"),
                f"{pre}/bias": (lead + (d,), None)}

    v = "backbone/vit"
    out = {**conv(f"{v}/patch_embed", p, 3, d),
           f"{v}/cls_token": ((1, 1, d), 0.02),
           f"{v}/pos_embed": ((1, gg + 1, d), 0.02)}
    out.update(norm(f"{v}/layers/norm1"))
    for n in ("wq", "wk", "wv", "wo"):
        out.update(lin(f"{v}/layers/attn/{n}", d, d))
    out.update(norm(f"{v}/layers/norm2"))
    out.update(lin(f"{v}/layers/mlp/up", d, ff))
    out.update(lin(f"{v}/layers/mlp/down", ff, d))
    out.update(norm(f"{v}/final_norm", stack=False))
    out.update(lin(f"{v}/head", d, s.n_classes, stack=False))
    out.update(conv("backbone/neck/lateral", 1, d, f))
    out.update(conv("backbone/neck/smooth", 3, f, f))
    out.update(conv("heads/cls", 3, f, s.n_classes))
    out.update(conv("heads/box", 3, f, 4))
    out.update(conv("heads/obj", 3, f, 1))
    return out


def make_weights(sizes, seed: int, device) -> dict:
    """The weight tree of `sizes` from `seed`, on `device`."""
    shapes = _shapes(sizes)
    drawn = [(k, sh, std) for k, (sh, std) in shapes.items()
             if isinstance(std, float)]
    n = sum(math.prod(sh) for _, sh, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)
    z = torch.empty(n, device=device)
    torch.nn.init.trunc_normal_(z, 0.0, 1.0, -2.0, 2.0, generator=gen)
    leaves, at = {}, 0
    for k, sh, std in drawn:
        m = math.prod(sh)
        leaves[k] = (z[at:at + m] * std).reshape(sh)
        at += m
    for k, (sh, std) in shapes.items():
        if not isinstance(std, float):
            fill = 1.0 if std == "one" else 0.0
            leaves[k] = torch.full(sh, fill, device=device)
    tree: dict = {}
    for k, x in leaves.items():
        node = tree
        *parts, last = k.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = x
    return tree

