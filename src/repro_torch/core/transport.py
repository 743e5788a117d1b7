"""Synthetic mobile network capacity (numpy, host side): the model behind
`serving.NetworkTrace.mobile` and the fleet's per-camera link traces."""
from __future__ import annotations

import numpy as np


def ar1_mobile_trace(T: int, base, rng: np.random.Generator) -> np.ndarray:
    """LTE-ish capacity: AR(1) around `base` (scalar or [F]) with 1% deep
    fades, clipped to [1, 2*base]. Returns [T, *base.shape]."""
    base = np.asarray(base, np.float64)
    x = np.empty((T,) + base.shape)
    x[0] = base
    for t in range(1, T):
        x[t] = 0.9 * x[t - 1] + 0.1 * base + rng.normal(0, 3.0, base.shape)
        fade = rng.random(base.shape) < 0.01
        x[t] = np.where(fade, x[t] * 0.3, x[t])
    return np.clip(x, 1.0, base * 2)
