"""Elastic re-sharding: resume a checkpoint on a different mesh.

When ranks die (or capacity grows), the job restarts on another rank
count. Checkpoints store whole tensors (train/checkpoint.py gathers a
DTensor before it writes); `reshard` lays a tree out on a new mesh from
them, and `shrink_mesh` builds the smaller mesh after a loss. The host
half — which data-parallel widths a surviving count allows, and the
global batch that keeps each replica's batch — is plain arithmetic.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.sharding import tree_leaves, tree_map_with_path


def _place(x, sharding):
    mesh, placements = sharding.mesh, sharding.placements()
    if isinstance(x, DTensor):
        if x.device_mesh == mesh:
            return x.redistribute(mesh, placements)
        x = x.full_tensor()
    return distribute_tensor(x, mesh, placements)


def reshard(tree, shardings_tree):
    """Place every leaf on its target `NamedSharding`
    (distributed/sharding.py): `distribute_tensor` for a plain tensor
    (every rank of the mesh passes the same whole tensor),
    `redistribute` for a DTensor on the same mesh, and `full_tensor()`
    then `distribute_tensor` across meshes. Collective over each target
    mesh (and a source mesh it leaves)."""
    targets = iter(tree_leaves(shardings_tree))
    return tree_map_with_path(lambda _, x: _place(x, next(targets)), tree)


def shrink_mesh(mesh: DeviceMesh, failed_axis: str, keep: int
                ) -> DeviceMesh:
    """The mesh with only the first `keep` slots along `failed_axis`
    (rank loss); `mesh` itself when `keep` is not smaller.

    Making a mesh creates its groups with `new_group`, which is
    collective over the whole world: every rank of the world calls
    this, the dropped ones too. A dropped rank gets a mesh it is not in
    (`get_coordinate()` is None): it may take part in collectives of
    the old mesh's groups and of the world that still hold it (the
    checkpoint's gather and barriers, say) and then leave; it holds no
    shard on the new mesh (a DTensor there has an empty local tensor on
    it)."""
    dim = mesh.mesh_dim_names.index(failed_axis)
    ranks = mesh.mesh
    if keep >= ranks.shape[dim]:
        return mesh
    index = [slice(None)] * ranks.ndim
    index[dim] = slice(0, keep)
    return DeviceMesh(mesh.device_type, ranks[tuple(index)].contiguous(),
                      mesh_dim_names=mesh.mesh_dim_names)


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
