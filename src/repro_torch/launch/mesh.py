"""Meshes over torch.distributed ranks.

Single pod  = 16 x 16 = 256 ranks   (axes: data, model)
Multi-pod   = 2 x 16 x 16 = 512 ranks (axes: pod, data, model)

`pod` is the slow axis: pure data parallelism with optional gradient
compression (train/compression.py). `data` carries DP and FSDP weight
sharding, and the fleet's cameras (fleet/runner.py); `model` carries
TP / EP / SP and pipeline stages (distributed/pipeline.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh`: one rank per
slot, its groups made with `new_group`. Making one is collective: every
rank of the world calls the same function with the same arguments.
`make_abstract_mesh` is a device-free stand-in with the same axis names
and sizes, for the sharding rules (distributed/sharding.py), which take
either.

Functions, never module-level meshes: importing this module creates no
process group.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.devices import resolve_device
from repro_torch.models.layout import (  # noqa: F401 (re-exported)
    AbstractMesh,
    axis_names,
    mesh_shape,
)

DEBUG_AXES = ("data", "model")


def make_abstract_mesh(shape: tuple, axes: tuple) -> AbstractMesh:
    """Device-free mesh for sharding-rule tests and dry runs."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    return AbstractMesh(tuple(axes), tuple(int(s) for s in shape))


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _too_few(n: int, shape: tuple) -> RuntimeError:
    return RuntimeError(
        f"need {n} devices for mesh {shape}, have {_world_size()} — start "
        f"{n} ranks with torch.distributed.init_process_group first")


def make_production_mesh(multi_pod: bool = False, *,
                         device=None) -> DeviceMesh:
    """The 256-rank pod mesh (16, 16) ("data", "model"), or with
    multi_pod the 512-rank (2, 16, 16) ("pod", "data", "model"), over the
    first ranks of the world. `device` as `devices.resolve_device`."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else DEBUG_AXES
    n = math.prod(shape)
    if _world_size() < n:
        raise _too_few(n, shape)
    dev = resolve_device(device)
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, *,
                    device=None) -> DeviceMesh:
    """An n_data x n_model ("data", "model") mesh over the whole world,
    whose size must be n_data * n_model.

    With no process group and a world of one, it makes the one-rank group
    itself, from a HashStore (no environment variables, no port): `nccl`
    on the card, `gloo` on the CPU. `device` follows
    `devices.resolve_device`: the card unless the caller passes "cpu"; it
    never falls back."""
    dev = resolve_device(device)
    n = n_data * n_model
    if not dist.is_initialized() and n == 1:
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    if _world_size() != n:
        raise _too_few(n, (n_data, n_model)) if _world_size() < n else \
            RuntimeError(f"mesh {(n_data, n_model)} needs a world of {n} "
                         f"ranks, have {_world_size()}")
    return init_device_mesh(dev.type, (n_data, n_model),
                            mesh_dim_names=DEBUG_AXES)
