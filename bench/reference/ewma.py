"""EWMA orientation labels (paper §3.3) over a [F, N] fleet batch.

Each orientation carries an EWMA of predicted workload accuracy and an
EWMA of the deltas between consecutive predictions; the label driving
shape evolution combines both.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


WINDOW = 10
ALPHA = 2.0 / (WINDOW + 1.0)


class EWMAState(NamedTuple):
    acc: torch.Tensor        # [F, N] EWMA of predicted accuracy
    delta: torch.Tensor      # [F, N] EWMA of accuracy deltas
    last: torch.Tensor       # [F, N] last observed predicted accuracy
    seen: torch.Tensor       # [F, N] visit counts (float)


def update(state: EWMAState, visited: torch.Tensor,
           acc_values: torch.Tensor, alpha: float = ALPHA) -> EWMAState:
    """visited [F, N] bool — cells explored this timestep; acc_values
    [F, N] predicted accuracy (junk where not visited)."""
    first = (state.seen == 0) & visited
    acc_new = torch.where(first, acc_values,
                          alpha * acc_values + (1 - alpha) * state.acc)
    acc = torch.where(visited, acc_new, state.acc)
    d = acc_values - state.last
    delta_new = torch.where(first, 0.0,
                            alpha * d + (1 - alpha) * state.delta)
    delta = torch.where(visited, delta_new, state.delta)
    last = torch.where(visited, acc_values, state.last)
    seen = state.seen + visited.to(state.seen.dtype)
    return EWMAState(acc, delta, last, seen)


def labels(state: EWMAState, *, delta_weight: float = 0.5,
           eps: float = 1e-3) -> torch.Tensor:
    """Per-orientation potential for the next timestep; strictly positive
    so head/tail ratios are well-defined."""
    raw = state.acc + delta_weight * state.delta
    return torch.clamp(raw, min=0.0) + eps


def decay_unvisited(state: EWMAState, visited: torch.Tensor,
                    rate: float = 0.98) -> EWMAState:
    """Optimism decay for cells not visited this step."""
    return state._replace(acc=torch.where(visited, state.acc,
                                          state.acc * rate))
