"""Elastic resizing, the host-side half: which data-parallel widths a
surviving device count allows, and the global batch that keeps each
replica's batch when that width changes.

Re-laying a checkpoint out on a new mesh (the reference's `reshard` and
`shrink_mesh`) belongs with the port's sharding, which is not ported
yet.
"""
from __future__ import annotations


def valid_submesh_sizes(n_devices: int, model_parallel: int) -> list[int]:
    """Data-parallel widths that evenly use the surviving devices."""
    out = []
    for dp in range(1, n_devices // model_parallel + 1):
        if dp * model_parallel <= n_devices:
            out.append(dp)
    return out


def rebalance_batch(global_batch: int, old_dp: int, new_dp: int) -> int:
    """Keep per-replica batch constant when the DP width changes; the
    caller rescales accumulation steps to preserve the optimizer's
    effective batch."""
    per_replica = global_batch // old_dp
    return per_replica * new_dp
