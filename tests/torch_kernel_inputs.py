"""Seeded numpy inputs for the port's kernel tests, shaped like the main
path's (22 object slots, the default 5x5 grid's 75 windows). Imports
numpy and the port only, so the card-only tests run where JAX is not
installed."""
import numpy as np
import torch

from repro_torch.core import DEFAULT_GRID
from repro_torch.kernels.cell_rasterize.ops import window_arrays
from repro_torch.kernels.neighbor_score.ops import geometry_arrays

M = 22          # 14 people + 8 cars
GEO = geometry_arrays(DEFAULT_GRID)


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
