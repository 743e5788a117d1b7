"""A model's weights, made on the device from the seed in one draw:
truncated normals (cut at two standard deviations), each leaf scaled by
the std its model module gives (`leaves(sizes)`: {path: (shape, std)}),
zeros or ones where it gives None or "one". The layout is the nested
dictionary the paths spell."""
from __future__ import annotations

import math

import torch


def make_weights(shapes: dict, seed: int, device) -> dict:
    """The weight tree of the leaves `shapes` from `seed`, on `device`:
    one draw, cut into the leaves with a float std in their order."""
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

