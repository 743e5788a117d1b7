"""Multi-pod dry run: build and run every (architecture x input-shape x
mesh) cell on shapes alone and extract its per-rank costs, memory and
collectives.

This is the proof that the distribution config is coherent without the
hardware: a sharding the layers cannot follow, an op DTensor cannot
partition, or an absurd memory footprint all surface here as errors or
pathological numbers.

What stands in for the reference's XLA dry run (`jax.jit(...).lower()
.compile()` on 512 forced host devices):

  - a "fake" process group of 512 ranks in this process (PyTorch's
    testing backend: every collective returns at once, nothing moves),
    and `make_production_mesh` on its first 256 or 512 ranks;
  - the cell's args as DTensors laid out by its in_shardings, their
    local shards fake tensors (FakeTensorMode: shapes, no memory) on
    `device` (the card unless the caller passes "cpu");
  - the step run under `implicit_replication()` (plain tensors the
    step makes meet DTensors as replicated), its outputs laid out by
    the out_shardings, with `LocalCosts` counting what one rank runs:
    the FLOPs of its local ops (`torch.utils.flop_counter`'s formulas,
    as FlopCounterMode counts them), the bytes they read and write, the
    peak of the bytes its tensors hold, and its collectives
    (`distributed.sharding.collective_bytes`).

Result keys are the reference's: `lower_s` is building the cell,
`compile_s` the fake run; there is no `generated_code_size_in_bytes`.
`bytes_per_device` is what one rank holds: its argument shards plus the
peak of the tensors the step makes. The reference divides the compiled
module's argument + temp bytes by the chip count again, which XLA
already reports per device; the port does not.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch vit-b16 \\
      --shape cls_224
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --both-meshes --out dryrun_results.json --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b \\
      --shape train_4k --one-rank --device cpu     # the 1 x 1 count
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ASSIGNED_ARCHS, get_config, shapes_for
from repro_torch.devices import resolve_device
from repro_torch.distributed.sharding import (
    CollectiveRecorder,
    collective_bytes,
    tree_leaves,
    tree_map_with_path,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models.layout import local_shape

# full-attention archs skip long_500k per the pool note in the reference
# (quadratic prefill is out of scope; decode is O(S) and IS run); every
# LM arch runs long_500k because decode against a 500k cache is linear
# per step: nothing to skip
SKIPPED_CELLS: set = set()

FAKE_WORLD = 512


def fake_world(n: int = FAKE_WORLD) -> None:
    """A "fake" process group of n ranks (this process rank 0) unless
    one of at least n ranks exists."""
    if dist.is_initialized():
        if dist.get_world_size() < n:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks exists; the dry run needs {n}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


_MESHES: dict = {}


def production_mesh(multi_pod: bool, device) -> object:
    """make_production_mesh on the fake world, made once per (multi_pod,
    device type) and world."""
    fake_world()
    key = (multi_pod, torch.device(device).type, dist.group.WORLD)
    if key not in _MESHES:
        _MESHES[key] = make_production_mesh(multi_pod, device=device)
    return _MESHES[key]


def one_rank_mesh(device) -> DeviceMesh:
    """A 1 x 1 ("data", "model") mesh on rank 0 of the fake world: the
    whole cell on one rank, the count a mesh's per-rank numbers are
    held against (and what a one-card real run does)."""
    fake_world(1)
    return DeviceMesh(torch.device(device).type,
                      torch.zeros(1, 1, dtype=torch.long),
                      mesh_dim_names=("data", "model"))


def mesh_label(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class LocalCosts(CollectiveRecorder):
    """What one rank runs, op by op on its local tensors: `flops` (the
    flop_counter formulas, with FlopCounterMode's decomposition of ops
    it has none for), `bytes_accessed` (each non-view op's inputs and
    outputs), the live and `peak` bytes of the storages the ops make
    (freed when their last tensor goes), and the collectives
    (`record`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self._held_outside: set = set()

    def exclude(self, tree) -> None:
        """Storages of `tree`'s tensors (the arguments) are not the
        step's: views and in-place results on them add nothing."""
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                local = t.to_local() if isinstance(t, DTensor) else t
                self._held_outside.add(local.untyped_storage()._cdata)

    def local_op(self, func, args, kwargs):
        if self.quiet or _on_meta(args, kwargs):
            # DTensor's bookkeeping on stand-ins of the global shapes,
            # not the rank's work
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = super().local_op(func, args, kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        outs = [t for t in torch.utils._pytree.tree_leaves(out)
                if isinstance(t, torch.Tensor)]
        if not func.is_view:
            ins = [t for t in torch.utils._pytree.tree_leaves((args,
                                                               kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            self._hold(t)
        return out

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held_outside:
            return
        if key in self._storages:
            self._storages[key][0] += 1
        else:
            self._storages[key] = [1, st.nbytes()]
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._drop, key)

    def _drop(self, key) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self.live -= entry[1]
            del self._storages[key]


def _on_meta(args, kwargs) -> bool:
    dev = kwargs.get("device")
    if dev is not None and torch.device(dev).type == "meta":
        return True
    return any(isinstance(t, torch.Tensor) and t.device.type == "meta"
               for t in torch.utils._pytree.tree_leaves(args))


def _contiguous_stride(shape: tuple) -> tuple:
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= max(s, 1)
    return tuple(reversed(stride))


def zip_map(fn, tree, shardings):
    """fn(leaf, sharding) over `tree` and the NamedShardings of a tree
    of the same structure, leaf by leaf (as elastic.reshard pairs
    them)."""
    targets = iter(tree_leaves(shardings))
    return tree_map_with_path(lambda _, x: fn(x, next(targets)), tree)


def dtensor_args(args, shardings, mesh, device):
    """The args tree (leaves with .shape and .dtype) as DTensors laid
    out by `shardings`, each local shard `torch.empty` of its local
    shape on `device` (fake under an active FakeTensorMode)."""
    def leaf(x, sh):
        shape = tuple(x.shape)
        pl = sh.placements()
        local = torch.empty(local_shape(shape, pl, mesh), dtype=x.dtype,
                            device=device)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_stride(shape))
    return zip_map(leaf, args, shardings)


def lay_out(out, shardings):
    """The step's outputs redistributed to `shardings` (as jit's
    out_shardings force them); plain tensors and host values pass."""
    def leaf(x, sh):
        if isinstance(x, DTensor):
            return x.redistribute(x.device_mesh, sh.placements())
        return x
    return zip_map(leaf, out, shardings)


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def fake_run(cell, mesh, device) -> tuple[dict, "LocalCosts"]:
    """Run the cell's step on fake DTensor args; returns the memory
    numbers (argument / output bytes per rank) and the costs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    costs = LocalCosts()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = dtensor_args(cell.args, cell.in_shardings, mesh, device)
        mem = {"argument_size_in_bytes": _local_bytes(args)}
        costs.exclude(args)
        with implicit_replication(), costs:
            out = lay_out(cell.fn(*args), cell.out_shardings)
        mem["output_size_in_bytes"] = _local_bytes(out)
        mem["temp_size_in_bytes"] = int(costs.peak)
        del out, args
    return mem, costs


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh=None, device=None, verbose: bool = True,
             sp_threshold: int = 262144) -> dict:
    """Dry-run one cell on `mesh` (default: the production mesh on the
    fake world, multi-pod or not); `device` the fake tensors' (the card
    unless the caller passes "cpu")."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = production_mesh(multi_pod, dev)
    t0 = time.time()
    cell = build_cell(arch, shape_name, mesh, sp_threshold=sp_threshold)
    t_lower = time.time() - t0
    mem, costs = fake_run(cell, mesh, dev)
    t_compile = time.time() - t0 - t_lower
    coll = collective_bytes(costs.record)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_label(mesh),
        "chips": int(mesh.size()),
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "flops": float(costs.flops),
        "bytes_accessed": float(costs.bytes_accessed),
        "collective_bytes": {k: int(v) for k, v in coll.items()},
        "collective_total": int(sum(coll.values())),
        **mem,
        "bytes_per_device": mem["argument_size_in_bytes"]
        + mem["temp_size_in_bytes"],
    }
    if verbose:
        print(f"[OK] {arch} x {shape_name} ({result['mesh']}): "
              f"flops={result['flops']:.3e} "
              f"coll={result['collective_total']:.3e}B "
              f"mem/dev={result['bytes_per_device'] / 2**30:.2f}GiB "
              f"compile={t_compile:.0f}s", flush=True)
    return result


def run_all(archs=None, shapes=None, *, multi_pod: bool = False,
            out_path: str | None = None, resume: dict | None = None,
            device=None):
    results = dict(resume or {})
    archs = archs or ASSIGNED_ARCHS
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            if shapes and shape.name not in shapes:
                continue
            if (arch, shape.name) in SKIPPED_CELLS:
                continue
            key = f"{arch}|{shape.name}|{'multi' if multi_pod else 'single'}"
            if key in results and "error" not in results[key]:
                continue
            try:
                results[key] = run_cell(arch, shape.name,
                                        multi_pod=multi_pod, device=device)
            except Exception as e:  # noqa: BLE001 — record and continue
                results[key] = {"arch": arch, "shape": shape.name,
                                "error": f"{type(e).__name__}: {e}"}
                print(f"[FAIL] {arch} x {shape.name}: {e}", flush=True)
                traceback.print_exc()
            if out_path:
                with open(out_path, "w") as f:
                    json.dump(results, f, indent=1)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--one-rank", action="store_true",
                    help="one cell on a 1 x 1 mesh (its whole count)")
    ap.add_argument("--device", default=None,
                    help="where the fake tensors live: cuda (default; "
                         "raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.all:
        resume = None
        if args.out and os.path.exists(args.out):
            with open(args.out) as f:
                resume = json.load(f)
        shapes = [args.shape] if args.shape else None
        archs = [args.arch] if args.arch else None
        res = run_all(archs=archs, shapes=shapes, multi_pod=args.multi_pod,
                      out_path=args.out, resume=resume, device=args.device)
        if args.both_meshes:
            res = run_all(archs=archs, shapes=shapes, multi_pod=True,
                          out_path=args.out, resume=res, device=args.device)
        n_ok = sum(1 for v in res.values() if "error" not in v)
        print(f"\n{n_ok}/{len(res)} cells OK")
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        mesh = one_rank_mesh(resolve_device(args.device)) \
            if args.one_rank else None
        r = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                     mesh=mesh, device=args.device)
        print(json.dumps(r, indent=2))


if __name__ == "__main__":
    main()
