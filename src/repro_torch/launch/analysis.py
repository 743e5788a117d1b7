"""Roofline analysis runs: per-step FLOP / byte / collective totals at
full depth from short runs.

The reference's XLA cost analysis counts a loop body once whatever its
trip count, so it lowers unrolled programs (REPRO_FULL_UNROLL) at 2-3
reduced depths. Here the count is taken op by op as the step runs
(`dryrun.LocalCosts`), so every loop trip is counted and no unroll
switch exists. The extrapolation stays: it turns a 61-layer kimi-k2
cell into two short fake runs. It is exact because per-layer structure
and sharding are depth-invariant:

  metric(L)        = a + c * L              (LM / vision / diffusion train)
  metric(S, D, Sg) = a + Sg * (b + c_d*D + c_s*Sg_single)   (samplers)

Each run is `dryrun.fake_run` on the production mesh of the fake world
(or the given mesh). Writes roofline_analysis.json.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.analysis --all \\
      --out roofline_analysis.json --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_shape, shapes_for
from repro_torch.configs import shapes as shapes_mod
from repro_torch.configs.base import (
    _REGISTRY,
    DiffusionConfig,
    LMConfig,
    ShapeSpec,
    VisionConfig,
)
from repro_torch.devices import resolve_device
from repro_torch.distributed.sharding import collective_bytes
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_cell

METRICS = ("flops", "bytes_accessed", "collective_total")


def _measure(arch: str, shape_name: str, mesh, device) -> dict:
    cell = build_cell(arch, shape_name, mesh)
    mem, costs = dryrun.fake_run(cell, mesh, device)
    coll = collective_bytes(costs.record)
    return {
        "flops": float(costs.flops),
        "bytes_accessed": float(costs.bytes_accessed),
        "collective_total": float(sum(coll.values())),
        "collective_bytes": {k: int(v) for k, v in coll.items()},
        "temp_bytes": mem["temp_size_in_bytes"],
        "arg_bytes": mem["argument_size_in_bytes"],
    }


def _register_variant(cfg, **changes):
    """Register a reduced-depth clone so build_cell can find it."""
    new = dataclasses.replace(cfg, **changes)
    _REGISTRY[new.name] = new
    return new


def _lm_variants(cfg: LMConfig):
    d = cfg.first_dense_layers
    l1, l2 = d + 2, d + 4
    v1 = _register_variant(cfg, name=f"{cfg.name}@L{l1}", n_layers=l1)
    v2 = _register_variant(cfg, name=f"{cfg.name}@L{l2}", n_layers=l2)
    return (v1, l1), (v2, l2), cfg.n_layers


def _vision_variants(cfg: VisionConfig):
    if cfg.swin:
        # swin stages are heterogeneous: cut every stage to at most 2
        # blocks for one measurement point, the full depths the other —
        # the metric is linear in the deep stage's block count
        d1 = tuple(min(x, 2) for x in cfg.depths)
        v1 = _register_variant(cfg, name=f"{cfg.name}@d1", depths=d1)
        return (v1, sum(d1)), (cfg, sum(cfg.depths)), sum(cfg.depths)
    l1, l2 = 2, 4
    v1 = _register_variant(cfg, name=f"{cfg.name}@L{l1}", n_layers=l1)
    v2 = _register_variant(cfg, name=f"{cfg.name}@L{l2}", n_layers=l2)
    return (v1, l1), (v2, l2), cfg.n_layers


def analyse_linear(arch: str, shape_name: str, mesh, device) -> dict:
    """Two-point extrapolation in layer count."""
    cfg = get_config(arch)
    if isinstance(cfg, LMConfig):
        (v1, l1), (v2, l2), depth = _lm_variants(cfg)
    elif isinstance(cfg, VisionConfig):
        (v1, l1), (v2, l2), depth = _vision_variants(cfg)
    else:
        raise TypeError(cfg)
    m1 = _measure(v1.name, shape_name, mesh, device)
    m2 = _measure(v2.name, shape_name, mesh, device)
    out = {}
    for k in METRICS:
        c = (m2[k] - m1[k]) / max(l2 - l1, 1)
        a = m1[k] - c * l1
        out[k] = a + c * depth
    out["collective_bytes"] = {
        k: int(m2["collective_bytes"].get(k, 0)
               + (m2["collective_bytes"].get(k, 0)
                  - m1["collective_bytes"].get(k, 0))
               / max(l2 - l1, 1) * (depth - l2))
        for k in set(m1["collective_bytes"]) | set(m2["collective_bytes"])}
    out["extrapolated_from"] = [l1, l2]
    out["full_depth"] = depth
    return out


def _block_variants(cfg: DiffusionConfig):
    """Two reduced-depth clones and their "block units" (an MMDiT double
    block counts as two singles; both are scaled 2x from the first
    clone to the second, so the measured slope holds for configs whose
    double:single ratio is 1:2, as flux-dev's 19:38 is)."""
    if cfg.is_mmdit:
        v1 = _register_variant(cfg, name=f"{cfg.name}@b1",
                               n_double_blocks=2, n_single_blocks=4)
        v2 = _register_variant(cfg, name=f"{cfg.name}@b2",
                               n_double_blocks=4, n_single_blocks=8)
        return (v1, 2 * 2 + 4), (v2, 2 * 4 + 8), \
            2 * cfg.n_double_blocks + cfg.n_single_blocks
    v1 = _register_variant(cfg, name=f"{cfg.name}@b1", n_layers=2)
    v2 = _register_variant(cfg, name=f"{cfg.name}@b2", n_layers=4)
    return (v1, 2), (v2, 4), cfg.n_layers


def analyse_diffusion(arch: str, shape_name: str, mesh, device) -> dict:
    cfg = get_config(arch)
    shape = get_shape(cfg, shape_name)
    (b1, u1), (b2, u2), units = _block_variants(cfg)
    if shape.kind == "train":
        # linear in block units
        m1 = _measure(b1.name, shape_name, mesh, device)
        m2 = _measure(b2.name, shape_name, mesh, device)
        out = {}
        for k in METRICS:
            c = (m2[k] - m1[k]) / (u2 - u1)
            out[k] = m1[k] - c * u1 + c * units
        out["collective_bytes"] = m2["collective_bytes"]
        out["extrapolated_from"] = [u1, u2]
        out["full_depth"] = units
        return out

    # sampler cells: metric = a + steps * step_cost(blocks); step_cost
    # linear in block units. 3 runs: (b1, s1), (b1, s2), (b2, s1).
    s1, s2, steps = 2, 4, shape.steps

    def measure(cfg_v, n_steps):
        """The cell at n_steps sampler steps: the family's shape table
        swapped for one whose `shape.name` entry has them."""
        sh = ShapeSpec(shape.name, shape.kind, img_res=shape.img_res,
                       global_batch=shape.global_batch, steps=n_steps)
        orig = shapes_mod.DIFFUSION_SHAPES
        try:
            shapes_mod.DIFFUSION_SHAPES = [
                sh if s.name == shape.name else s for s in orig]
            shapes_mod.FAMILY_SHAPES["diffusion"] = \
                shapes_mod.DIFFUSION_SHAPES
            return _measure(cfg_v.name, shape.name, mesh, device)
        finally:
            shapes_mod.DIFFUSION_SHAPES = orig
            shapes_mod.FAMILY_SHAPES["diffusion"] = orig

    m11 = measure(b1, s1)
    m12 = measure(b1, s2)
    m21 = measure(b2, s1)
    out = {}
    for k in METRICS:
        step_b1 = (m12[k] - m11[k]) / (s2 - s1)     # per-step @ u1 blocks
        a = m11[k] - s1 * step_b1                   # steps-independent part
        dstep_db = ((m21[k] - a) / s1 - step_b1) / (u2 - u1)
        step_full = step_b1 + dstep_db * (units - u1)
        out[k] = a + steps * step_full
    out["collective_bytes"] = m12["collective_bytes"]
    out["extrapolated_from"] = [[u1, s1], [u1, s2], [u2, s1]]
    out["full_depth"] = [units, steps]
    return out


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh=None, device=None) -> dict:
    """The analysis of one cell on `mesh` (default: the production mesh
    of the fake world); `device` the fake tensors' (the card unless the
    caller passes "cpu")."""
    dev = resolve_device(device)
    if mesh is None:
        mesh = dryrun.production_mesh(multi_pod, dev)
    cfg = get_config(arch)
    t0 = time.time()
    if isinstance(cfg, DiffusionConfig):
        out = analyse_diffusion(arch, shape_name, mesh, dev)
    else:
        out = analyse_linear(arch, shape_name, mesh, dev)
    out.update({
        "arch": arch, "shape": shape_name,
        "mesh": dryrun.mesh_label(mesh),
        "chips": int(mesh.size()),
        "analysis_s": round(time.time() - t0, 1),
    })
    print(f"[OK] {arch} x {shape_name}: flops={out['flops']:.3e} "
          f"bytes={out['bytes_accessed']:.3e} "
          f"coll={out['collective_total']:.3e} ({out['analysis_s']}s)",
          flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="roofline_analysis.json")
    ap.add_argument("--device", default=None,
                    help="where the fake tensors live: cuda (default; "
                         "raises without a card) or cpu")
    args = ap.parse_args(argv)

    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    for arch in archs:
        cfg = get_config(arch)
        for shape in shapes_for(cfg):
            if args.shape and shape.name != args.shape:
                continue
            key = (f"{arch}|{shape.name}|"
                   f"{'multi' if args.multi_pod else 'single'}")
            if key in results and "error" not in results[key]:
                continue
            try:
                results[key] = run_cell(arch, shape.name,
                                        multi_pod=args.multi_pod,
                                        device=args.device)
            except Exception as e:  # noqa: BLE001
                results[key] = {"arch": arch, "shape": shape.name,
                                "error": f"{type(e).__name__}: {e}"}
                print(f"[FAIL] {arch} x {shape.name}: {e}", flush=True)
                traceback.print_exc()
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(1 for v in results.values() if "error" not in v)
    print(f"\n{n_ok}/{len(results)} analysed")


if __name__ == "__main__":
    main()
