"""Seeded numpy inputs for the port's kernel tests, shaped like the main
path's (22 object slots, the default 5x5 grid's 75 windows), and fleet
states for the shape-search kernels on grids of 25, 50 and 128 cells.
Imports numpy and the port only, so the card-only tests run where JAX is
not installed."""
import numpy as np
import torch

from repro_torch.core import DEFAULT_GRID, OrientationGrid
from repro_torch.kernels.cell_rasterize.ops import window_arrays
from repro_torch.kernels.neighbor_score.ops import geometry_arrays

M = 22          # 14 people + 8 cars
GEO = geometry_arrays(DEFAULT_GRID)
# the default 5x5 grid, bench_deepdive's pan step 15 (10x5) and the
# kernels' largest grid (16x8)
SEARCH_GRIDS = {25: DEFAULT_GRID, 50: OrientationGrid(pan_step=15.0),
                128: OrientationGrid(pan_step=9.375, tilt_step=9.375)}


def t(x):
    """numpy/jax array -> CPU tensor (ints as int64)."""
    a = np.asarray(x)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.as_tensor(a.copy())


def neighbor_inputs(b, seed):
    rng = np.random.default_rng(seed)
    n = DEFAULT_GRID.n_cells
    shape = rng.random((b, n)) < 0.35
    has = rng.random((b, n)) < 0.7
    cent = (np.asarray(DEFAULT_GRID.centers, np.float32)[None]
            + rng.normal(0, 8, (b, n, 2))).astype(np.float32)
    head = rng.integers(0, n, b)
    return shape, has, cent, head


def rasterize_inputs(f, p, seed):
    rng = np.random.default_rng(seed)
    ox = rng.uniform(0, 150, (f, M)).astype(np.float32)
    oy = rng.uniform(0, 75, (f, M)).astype(np.float32)
    ow = rng.uniform(1.0, 9.0, (f, M)).astype(np.float32)
    oh = rng.uniform(1.0, 9.0, (f, M)).astype(np.float32)
    ow[:, -2:] = oh[:, -2:] = 0.0                  # disabled slots
    draw = rng.uniform(0, 1.2, (f, p, M)).astype(np.float32)
    draw[rng.random((f, p, M)) < 0.2] = 2.0
    a0 = rng.uniform(0.03, 0.1, p).astype(np.float32)
    a1 = (a0 + rng.uniform(0.05, 0.2, p)).astype(np.float32)
    win = window_arrays(DEFAULT_GRID)
    return ox, oy, ow, oh, draw, a0, a1, win


def patchify_inputs(f, k, d, seed, shared):
    rng = np.random.default_rng(seed)
    pos = rng.uniform([0, 0], [150, 75], (f, M, 2)).astype(np.float32)
    size = rng.uniform(1.5, 9.0, (f, M, 2)).astype(np.float32)
    size[:, -2:] = 0.0                             # disabled slots
    kind = (np.arange(M) >= 14).astype(np.int32)
    oid = rng.integers(0, 4000, (f, M)).astype(np.int32)
    wins_all = window_arrays(DEFAULT_GRID)
    if shared:
        wins = wins_all[:k]
    else:
        wins = wins_all[np.stack([rng.choice(wins_all.shape[0], k,
                                             replace=False)
                                  for _ in range(f)])]
    pe = {"w": (rng.normal(0, 0.05, (16, 16, 3, d))).astype(np.float32),
          "b": rng.normal(0, 0.01, d).astype(np.float32)}
    noise = (0.05 * rng.normal(0, 1, (f, 64, 64, 3))).astype(np.float32)
    return pos, size, kind, oid, wins, pe, noise


def _blob(rng, grid, size):
    """A random 8-connected shape of `size` cells (grown cell by cell)."""
    n = grid.n_cells
    nbr = np.asarray(grid.neighbor_mask)
    mask = np.zeros(n, bool)
    mask[rng.integers(n)] = True
    while mask.sum() < size:
        frontier = np.flatnonzero(nbr[mask].any(0) & ~mask)
        mask[rng.choice(frontier)] = True
    return mask


def _shapes(rng, grid, f):
    """F shapes of every kind, in turn from a seeded offset: empty,
    1-member, 8-connected blobs (whose induced MST is often cut in pieces:
    the walk's stitch), scattered (not 8-connected), full."""
    n = grid.n_cells
    out = np.zeros((f, n), bool)
    off = int(rng.integers(12))
    for i in range(f):
        kind = (i + off) % 12
        if kind in (0, 6):
            out[i] = np.arange(n) == rng.integers(n)
        elif kind in (1, 2, 3, 7, 8, 9):
            out[i] = _blob(rng, grid, rng.integers(2, n // 2 + 2))
        elif kind in (4, 10):
            out[i] = rng.random(n) < rng.uniform(0.1, 0.5)
        elif kind == 5:
            out[i] = True
    return out                                   # kind 11: empty


def _labels(rng, f, n):
    """Ties on purpose: half the cameras quantized to quarters with many
    exact zeros, a quarter at one constant value, the rest continuous."""
    lab = rng.uniform(0, 1, (f, n)).astype(np.float32)
    q = (rng.integers(0, 4, (f, n)) / 4).astype(np.float32)
    q[rng.random((f, n)) < 0.4] = 0.0
    kind = (np.arange(f) + rng.integers(4)) % 4
    lab[kind < 2] = q[kind < 2]
    lab[kind == 2] = np.float32(0.25)
    return lab


def search_state(grid, f, seed):
    """(shape, labels, has_boxes, centroids) of F cameras: numpy, seeded.
    Every seventh camera has no boxes (every score the neutral 1.0)."""
    n = grid.n_cells
    rng = np.random.default_rng(seed)
    shape = _shapes(rng, grid, f)
    has = rng.random((f, n)) < 0.6
    has[::7] = False
    cent = (np.asarray(grid.centers, np.float32)[None]
            + rng.normal(0, 6, (f, n, 2))).astype(np.float32)
    return shape, _labels(rng, f, n), has, cent
