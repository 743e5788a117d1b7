"""Fleet shape search (paper §3.3): the rectangular seed, and the
search's masked loops.

The loops (`evolve_shape`, `resize_shape`, `first_removable` and the
contiguity tests) live in `shape_search`, re-exported here.
"""
from __future__ import annotations

import torch

from bench.reference.fleet_state import FleetConfig, FleetStatics
from bench.reference.shape_search import (  # noqa: F401
    _onehot,
    evolve_shape,
    first_removable,
    flood_reach,
    is_contiguous,
    resize_shape,
)


# ---------------------------------------------------------------------------
# rectangular seed
# ---------------------------------------------------------------------------

def seed_shape(statics: FleetStatics, cfg: FleetConfig, size: torch.Tensor,
               center: torch.Tensor) -> torch.Tensor:
    """size [F] int, center [F] int -> [F, N] bool rectangle of ~size
    cells around center."""
    n = cfg.n_cells
    size = torch.clamp(size, 0, n)
    w = statics.rect_w[size]                               # [F]
    h = statics.rect_h[size]
    cp = statics.coords[center, 0]
    ct = statics.coords[center, 1]
    p0 = torch.minimum(torch.clamp(cp - w // 2, min=0), cfg.n_pan - w)
    t0 = torch.minimum(torch.clamp(ct - h // 2, min=0), cfg.n_tilt - h)
    px = statics.coords[None, :, 0]                        # [1, N]
    tx = statics.coords[None, :, 1]
    return ((px >= p0[:, None]) & (px < (p0 + w)[:, None])
            & (tx >= t0[:, None]) & (tx < (t0 + h)[:, None]))
