"""Shapes and layouts, below the models: what a tensor's shape and dtype
are without memory (`TensorSpec`), a mesh's axis names and sizes, and
how a spec of axis names lays a tensor of a given shape out on it
(`NamedSharding`, `activation_sharding`, `local_shape`).

The models read these to lay activations out on a mesh; the sharding
rules (distributed/sharding.py), the trainer and the launchers import
them from here. This module imports torch only.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard


@dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one tensor, nothing allocated (what
    `jax.ShapeDtypeStruct` is to the reference)."""
    shape: tuple
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# meshes: a DeviceMesh or a device-free AbstractMesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without devices or ranks: what the sharding
    rules read of a mesh (`axis_names`, `shape` as a name -> size
    mapping, `size`)."""
    axis_names: tuple
    axis_sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_shape(mesh) -> dict:
    """name -> size of a DeviceMesh or an AbstractMesh."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    raise TypeError(f"not a mesh: {type(mesh).__name__} (a DeviceMesh or "
                    f"an AbstractMesh)")


def axis_names(mesh) -> tuple:
    """A DeviceMesh's dim names or an AbstractMesh's axis names."""
    return tuple(mesh_shape(mesh))


def dp_axes(mesh) -> tuple:
    """The data-parallel mesh axes (pod + data when multi-pod)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names) or (names[0],)


def axis_size(mesh, axis) -> int:
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= shape[a]
        return n
    return shape[axis]


def fits(dim: int, mesh, axis) -> bool:
    """The axis (or axes) divides dim."""
    return dim % axis_size(mesh, axis) == 0


def spec_entry(axis):
    """A spec entry as PartitionSpec keeps it: a one-axis tuple is the
    axis name."""
    return axis[0] if isinstance(axis, tuple) and len(axis) == 1 else axis


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class NamedSharding:
    """A layout on `mesh`: `spec[d]` names the mesh axes tensor dim d is
    split over (None: whole), as jax's PartitionSpec entries."""
    mesh: object
    spec: tuple

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: Shard(d) on every mesh
        dim named by spec[d] (a tuple of axes shards dim d over each of
        them, the first axis major, as JAX orders them), Replicate()
        elsewhere."""
        names = axis_names(self.mesh)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            for a in entry if isinstance(entry, tuple) else (entry,):
                out[names.index(a)] = Shard(d)
        return tuple(out)


def local_shape(shape: tuple, placements, mesh) -> tuple:
    """The shape of rank 0's shard of a tensor of `shape` laid out by
    `placements` on `mesh` (a dim split unevenly: its largest shard)."""
    out = list(shape)
    for size, p in zip(mesh.shape, placements):
        if p.is_shard():
            out[p.dim] = -(-out[p.dim] // size)
    return tuple(out)


def activation_sharding(mesh, shape: tuple, spec: tuple) -> NamedSharding:
    """The layout of an activation of `shape` by `spec` (one entry a
    dim: None, "data" for the DP axes, or a mesh axis name), as the
    reference's `constrain_spec` resolves it: an entry whose axis the
    mesh lacks, or whose axes do not divide the dim, leaves the dim
    whole, as does a dim of size 1 (DTensor will not fold a sharded
    dim of size 1 into another)."""
    names = axis_names(mesh)
    out = []
    for dim, entry in zip(shape, spec):
        axis = dp_axes(mesh) if entry == "data" else entry
        if axis is None or dim == 1 or any(a not in names for a in (
                axis if isinstance(axis, tuple) else (axis,))) \
                or not fits(dim, mesh, axis):
            out.append(None)
        else:
            out.append(spec_entry(axis))
    return NamedSharding(mesh, tuple(out))
