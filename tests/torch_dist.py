"""Multi-rank runs for the port's sharding tests, on the CPU and on the
card: n spawned processes in one `gloo` group over a `file://`
store (never a TCP port: the test workers run side by side), each on
one intra-op thread.

    ranks = spawn(fn, 4, tmp_path, *args)   # starts the ranks
    ...                                       # the parent works meanwhile
    results = ranks.join()                    # [fn(rank, *args) per rank]

`fn` must be importable by name (a module-level function): the ranks
start from a fresh interpreter (`spawn`, never `fork`). The rank bodies
of tests/test_torch_distributed.py, tests/test_torch_fleet_shard.py,
tests/test_torch_launch.py and tests/test_torch_shard_cuda.py live
below, so that a rank imports torch and the port only, not JAX.
`spawn_alone` starts one process with no group (the dry run makes its
own "fake" world there).
"""
from __future__ import annotations

import os
import pickle
import queue
import time
import traceback
import uuid

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 300


def _rank_main(fn, rank, n, store, args, out):
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=n)
        try:
            res = ("ok", fn(rank, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        res = ("error", traceback.format_exc())
    out.put((rank, pickle.dumps(res)))


class Ranks:
    """Running ranks; `join()` returns each rank's result in rank order
    and raises with the traceback of any rank that failed."""

    def __init__(self, procs, out):
        self.procs, self.out = procs, out
        self.results = None

    def join(self, timeout: float = TIMEOUT_S) -> list:
        if self.results is None:
            self.results = self._collect(timeout)
        return self.results

    def _collect(self, timeout: float) -> list:
        got = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < len(self.procs):
                try:
                    rank, blob = self.out.get(timeout=1.0)
                    got[rank] = pickle.loads(blob)
                    continue
                except queue.Empty:
                    pass
                dead = [r for r, p in enumerate(self.procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} died without a "
                                       f"result")
                if time.monotonic() > deadline:
                    silent = sorted(set(range(len(self.procs))) - set(got))
                    raise TimeoutError(f"ranks {silent} gave no result in "
                                       f"{timeout} s")
        finally:
            for p in self.procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
        failed = [f"rank {r}:\n{v}" for r, (k, v) in sorted(got.items())
                  if k == "error"]
        if failed:
            raise AssertionError("\n".join(failed))
        return [got[r][1] for r in range(len(self.procs))]


def spawn(fn, n: int, tmp_path, *args) -> Ranks:
    """Start `n` ranks running fn(rank, *args) in a gloo group whose
    store is a fresh file under tmp_path (one per group: two groups on
    one file store would mix)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = os.path.join(str(tmp_path), f"store-{uuid.uuid4().hex}")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, store, args, out), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    return Ranks(procs, out)


def _alone_main(fn, args, out):
    try:
        torch.set_num_threads(1)
        try:
            res = ("ok", fn(0, *args))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        res = ("error", traceback.format_exc())
    out.put((0, pickle.dumps(res)))


def spawn_alone(fn, *args) -> Ranks:
    """Start one process running fn(0, *args) with no process group of
    ours: fn makes its own (the dry run's "fake" world), which goes with
    the process."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    proc = ctx.Process(target=_alone_main, args=(fn, args, out),
                       daemon=True)
    proc.start()
    return Ranks([proc], out)


# ---------------------------------------------------------------------------
# rank bodies: tests/test_torch_distributed.py
# ---------------------------------------------------------------------------

def _np(tree):
    """Tensors to numpy through dicts, NamedTuples (as dicts of their
    fields), lists and tuples."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _np(v) for k, v in tree._asdict().items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.detach().cpu().numpy()


def collectives_rank(rank, q, k, v, grads, scale):
    """ring_reduce_attend on this rank's quarter of the cache (float32
    and bf16), psum_scatter_grads and ring_allgather."""
    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import make_debug_mesh

    mesh = make_debug_mesh(1, 4, device="cpu")
    grp = (mesh, "model")
    s = k.shape[1] // 4
    sl = slice(rank * s, (rank + 1) * s)
    out = {}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        qt = torch.as_tensor(q).to(dt)
        out[f"attend_{name}"] = col.ring_reduce_attend(
            qt, torch.as_tensor(k[:, sl]).to(dt),
            torch.as_tensor(v[:, sl]).to(dt), grp,
            scale=scale).float().numpy()
    mine = {n: torch.as_tensor(g[rank]) for n, g in grads.items()}
    out["scatter"] = _np(col.psum_scatter_grads(mine, grp))
    out["allgather"] = col.ring_allgather(
        torch.full((3,), float(rank)), mesh.get_group("model")).numpy()
    return out


def pipeline_rank(rank, params, x, n_stages):
    """make_pipelined_forward over a (1, n_stages) mesh, tanh(x w + b)
    layers."""
    from repro_torch.distributed.pipeline import (
        make_pipelined_forward,
        split_stages,
    )
    from repro_torch.launch.mesh import make_debug_mesh

    def body(lp, h, extra):
        return torch.tanh(h @ lp["w"] + lp["b"])

    mesh = make_debug_mesh(1, n_stages, device="cpu")
    fn = make_pipelined_forward(body, mesh, n_stages)
    p = {k: torch.as_tensor(a) for k, a in params.items()}
    xt = torch.as_tensor(x)
    piped = fn(split_stages(p, n_stages), xt).numpy()
    seq = []
    for h in xt:
        for i in range(p["w"].shape[0]):
            h = body({"w": p["w"][i], "b": p["b"][i]}, h, None)
        seq.append(h)
    return piped, torch.stack(seq).numpy()


def elastic_rank(rank, ckpt_dir):
    """Save on a (4,) data mesh, shrink to 2, restore, reshard, and take
    one step on the new mesh (the reference's elastic end to end)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (
        DTensor,
        Replicate,
        distribute_tensor,
    )

    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.elastic import (
        rebalance_batch,
        reshard,
        shrink_mesh,
    )

    mesh4 = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    whole = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    params = reshard({"w": whole}, {"w": NamedSharding(mesh4, ("data",
                                                               None))})
    out = {"local4": tuple(params["w"].to_local().shape)}
    ckpt.save(ckpt_dir, 10, params)
    mesh2 = shrink_mesh(mesh4, "data", 2)
    out["same"] = shrink_mesh(mesh4, "data", 4) is mesh4
    out["mesh2"] = mesh2.mesh.tolist()
    out["coord2"] = mesh2.get_coordinate()
    restored, manifest = ckpt.restore(ckpt_dir, 10, {"w": whole})
    out["n_processes"] = manifest["n_processes"]
    sh2 = {"w": NamedSharding(mesh2, ("data", None))}
    resharded = reshard(restored, sh2)
    out["local2"] = tuple(resharded["w"].to_local().shape)
    # across meshes: the (4,)-mesh DTensor straight onto the (2,) mesh
    moved = reshard(params, sh2)
    out["moved_local2"] = moved["w"].to_local().numpy()
    if out["coord2"] is not None:
        out["w2"] = resharded["w"].full_tensor().numpy()
        w = resharded["w"]
        eye = distribute_tensor(torch.eye(4), mesh2, [Replicate()])
        step = w - 0.1 * (w @ eye)
        out["step"] = (type(step).__name__, tuple(step.shape),
                       step.full_tensor().numpy())
    # same mesh: Shard(0) -> Replicate
    rep = reshard(params, {"w": NamedSharding(mesh4, ())})
    out["replicated"] = (isinstance(rep["w"], DTensor),
                         rep["w"].to_local().numpy())
    out["batch"] = rebalance_batch(256, old_dp=4, new_dp=2)
    return out


def distributed_rank(rank, tmp, attend, pipe, grads_g):
    """Every check of tests/test_torch_distributed.py in one spawn."""
    return {"collectives": collectives_rank(rank, *attend),
            "pipeline": pipeline_rank(rank, *pipe),
            "elastic": elastic_rank(rank, os.path.join(tmp, "ckpt")),
            "compression": compression_rank(rank, *grads_g)}


def compression_rank(rank, g, n_steps):
    """crosspod_allreduce_compressed on a (2, 2) ("pod", "data") mesh:
    rank (p, d) holds pod p's gradient rows for data shard d."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.train import compression as comp

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    p, d = mesh.get_coordinate()
    mine = torch.as_tensor(g[2 * p + d])
    err = comp.init_ef({"w": mine})
    means = []
    for _ in range(n_steps):
        mean, err = comp.crosspod_allreduce_compressed(
            {"w": mine}, err, group=(mesh, "pod"))
        means.append(mean["w"].numpy())
    return np.stack(means)


# ---------------------------------------------------------------------------
# rank bodies: tests/test_torch_fleet_shard.py
# ---------------------------------------------------------------------------

def _result_np(res):
    """What the fleet tests compare of a FleetResult, as numpy."""
    out = {"chosen": res.chosen, "frames_sent": res.frames_sent,
           "accuracy": res.accuracy, "acc_per_step": res.acc_per_step,
           "distill_loss": res.distill_loss, "out": _np(res.out),
           "state": _np(res.state), "metrics": _np(res.metrics),
           "steady_s": res.timings["steady_s"]}
    if res.learned is not None:
        out["heads"] = _np(res.learned_params(None)["heads"])
    return out


def _fleet_specs(specs, n_data, n_model):
    """(name, FleetRunSpec, mesh or None) of each (spec JSON, how) in
    `specs`: how "shard" puts ShardSpec("debug", n_data, n_model) in the
    spec; "mesh" keeps the spec and passes a mesh."""
    from repro_torch.fleet.api import FleetRunSpec, ShardSpec
    from repro_torch.launch.mesh import make_debug_mesh

    for name, (js, how) in specs.items():
        spec = FleetRunSpec.from_json(js)
        if how == "mesh":
            yield name, spec, make_debug_mesh(n_data, n_model, device="cpu")
        else:
            yield name, FleetRunSpec(**{**vars(spec), "shard": ShardSpec(
                "debug", n_data, n_model)}), None


def _tables_run(mbps, mesh):
    """The tables provider with a per-camera [E, F] link trace `mbps`
    through run_fleet_episode, on `mesh` (None: unsharded)."""
    from repro_torch.core import DEFAULT_GRID
    from repro_torch.core.tradeoff import BudgetConfig
    from repro_torch.fleet.api import FleetRunSpec
    from repro_torch.fleet.runner import make_tables_provider, \
        run_fleet_episode
    from repro_torch.fleet.state import fleet_config, fleet_statics, \
        workload_spec

    cfg = fleet_config(DEFAULT_GRID, BudgetConfig(fps=3.0))
    wl = FleetRunSpec().workload_obj()
    n_steps, f = mbps.shape
    ep, state = make_tables_provider(DEFAULT_GRID, wl, cfg, n_cameras=f,
                                     n_steps=n_steps, device="cpu")
    link = torch.as_tensor(mbps)
    ep = ep._replace(mbps=link, rtt=ep.rtt[:, None].expand(link.shape)
                     .contiguous())
    with torch.no_grad():
        st, o, _, _ = run_fleet_episode(cfg, workload_spec(wl),
                                        fleet_statics(DEFAULT_GRID, "cpu"),
                                        state, ep, mesh=mesh)
    return {"out": _np(o), "state": _np(st)}


def engine_rank(rank, det_npz, n_data, n_model):
    """The three controller shims with mesh= against the same shims
    without it."""
    from repro_torch.core import DEFAULT_GRID
    from repro_torch.core.tradeoff import BudgetConfig
    from repro_torch.data import SceneConfig, build_video
    from repro_torch.fleet.api import FleetRunSpec
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.serving import NetworkTrace, detection_tables
    from repro_torch.serving import engine

    mesh = make_debug_mesh(n_data, n_model, device="cpu")
    budget = BudgetConfig(fps=3.0)
    wl = FleetRunSpec().workload_obj()
    video = build_video(DEFAULT_GRID, SceneConfig(fps=15.0, seed=2), 1.5)
    calls = {
        "tables": lambda m: engine.run_fleet_controller(
            video, wl, detection_tables(video, wl), budget,
            NetworkTrace.fixed(24.0, 20.0, video.n_frames), n_cameras=4,
            max_steps=3, mesh=m, device="cpu"),
        "scene": lambda m: engine.run_fleet_scene_controller(
            DEFAULT_GRID, wl, budget, n_cameras=4, n_steps=3, mesh=m,
            device="cpu"),
        "detector": lambda m: engine.run_fleet_detector_controller(
            DEFAULT_GRID, wl, budget, n_cameras=4, n_steps=3, mesh=m,
            det_params=det_npz, shortlist_k=9, thresh=0.3, device="cpu"),
    }
    out = {}
    for name, call in calls.items():
        got = [call(m) for m in (None, mesh)]
        out[name] = [_np(o) for _, o in got]
    return out


def uneven_rank(rank, n_data, n_model):
    """A fleet that does not split over the data ranks raises on every
    rank, before any collective."""
    from repro_torch.fleet.api import FleetRunSpec, run_fleet

    try:
        run_fleet(FleetRunSpec(provider="scene", n_cameras=3, n_steps=2,
                               shard={"kind": "debug", "n_data": n_data,
                                      "n_model": n_model}),
                  device="cpu")
    except ValueError as e:
        return str(e)
    return None


def fleet_suite_rank(rank, specs, meshes, mbps, det_npz=None):
    """Every multi-rank check of tests/test_torch_fleet_shard.py, for
    each (n_data, n_model) of `meshes` over the whole world: the specs
    through run_fleet and the tables provider with a per-camera link,
    sharded. With `det_npz` (one spawn of the file), rank 0 first runs
    each unsharded (one thread, as every rank), and every rank checks
    the controller shims and a fleet that does not split."""
    from repro_torch.fleet.api import FleetRunSpec, run_fleet
    from repro_torch.launch.mesh import make_debug_mesh

    out = {}
    if det_npz is not None and rank == 0:
        out["whole"] = {"runs": {
            name: _result_np(run_fleet(FleetRunSpec.from_json(js),
                                       device="cpu"))
            for name, (js, _) in specs.items()},
            "tables": _tables_run(mbps, None)}
    for n_data, n_model in meshes:
        runs = {name: _result_np(run_fleet(spec, mesh=mesh, device="cpu"))
                for name, spec, mesh in _fleet_specs(specs, n_data,
                                                     n_model)}
        out[(n_data, n_model)] = {
            "runs": runs, "tables": _tables_run(
                mbps, make_debug_mesh(n_data, n_model, device="cpu"))}
    if det_npz is not None:
        n_data, n_model = meshes[0]
        out["engine"] = engine_rank(rank, det_npz, n_data, n_model)
        out["uneven"] = uneven_rank(rank, n_data, n_model)
    return out


def card_fleet_rank(rank, spec, n_data):
    """One of n_data processes sharing cuda:0 in the gloo group (NCCL
    refuses two ranks on one device): its share of `spec`'s fleet with
    ShardSpec("debug", n_data) -> what the card test compares, and the
    kernels it launched but threefry and dense."""
    import dataclasses

    from repro_torch.fleet.api import ShardSpec, run_fleet
    from repro_torch.kernels import _lib

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _lib.reset_launch_counts()
    res = run_fleet(dataclasses.replace(
        spec, shard=ShardSpec("debug", n_data=n_data)))
    torch.cuda.synchronize()
    return {"chosen": res.chosen, "frames_sent": res.frames_sent,
            "accuracy": res.accuracy,
            "pred_acc": res.out.pred_acc.cpu().numpy(),
            "launches": {k: v for k, v in _lib.launch_counts().items()
                         if v and k not in ("threefry", "dense")}}


# ---------------------------------------------------------------------------
# process bodies: tests/test_torch_launch.py (a "fake" world of 4 ranks,
# this process rank 0; nothing moves between ranks)
# ---------------------------------------------------------------------------

def _fake_world(n: int = 4):
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import dryrun

    dryrun.fake_world(n)
    two = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                     mesh_dim_names=("data", "model"))
    return two, dryrun.one_rank_mesh("cpu")


def smoke_variant(arch: str, **changes) -> str:
    """Register arch's SMOKE config under "<arch>@smoke" (with
    `changes`) for build_cell; returns the name."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import _REGISTRY

    name = f"{arch}@smoke"
    _REGISTRY[name] = dataclasses.replace(get_smoke_config(arch), name=name,
                                          **changes)
    return name


def collective_cases(mesh) -> dict:
    """{case: (collective_bytes of its record, the outputs' local shape
    and dtype)} of four redistributions of known DTensors on the (2, 2)
    mesh."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import (
        CollectiveRecorder,
        collective_bytes,
    )

    cases = {
        "S(0)->R": ((8, 6), torch.float32, (Shard(0), Replicate()),
                    (Replicate(), Replicate())),
        "P->R": ((4, 6), torch.bfloat16, (Partial(), Replicate()),
                 (Replicate(), Replicate())),
        "P->S(0)": ((8, 6), torch.float32, (Partial(), Replicate()),
                    (Shard(0), Replicate())),
        "S(0)->S(1)": ((8, 6), torch.float32, (Replicate(), Shard(0)),
                       (Replicate(), Shard(1))),
    }
    out = {}
    with FakeTensorMode():
        for name, (shape, dt, src, dst) in cases.items():
            local = [s // 2 if any(p.is_shard(i) for p in src) else s
                     for i, s in enumerate(shape)]
            x = DTensor.from_local(torch.empty(local, dtype=dt), mesh, src,
                                   run_check=False)
            rec = CollectiveRecorder()
            with rec:
                y = x.redistribute(mesh, dst)
            out[name] = (collective_bytes(rec.record),
                         tuple(y.to_local().shape), str(dt))
    return out


def launch_rank(_, cells, parity_cells):
    """The dry run's pieces on a fake world: collective_cases, run_cell
    on each SMOKE (arch, shape) of `cells` on the (2, 2) mesh, and for
    `parity_cells` the dry run's FLOPs on a 1 x 1 mesh beside
    FlopCounterMode's count of the real run (build_cell's fn on the
    cell's make_args, numpy weights, laid out on the same mesh)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_cell
    from repro_torch.train.elastic import reshard

    two, one = _fake_world()
    out = {"collectives": collective_cases(two), "cells": {}, "parity": {}}
    for arch, shape in cells:
        out["cells"][(arch, shape)] = dryrun.run_cell(
            smoke_variant(arch), shape, mesh=two, device="cpu",
            verbose=False)
    for arch, shape in parity_cells:
        cell = build_cell(smoke_variant(arch), shape, one)
        dry = dryrun.run_cell(cell.arch, shape, mesh=one, device="cpu",
                              verbose=False)
        args = reshard(cell.make_args(np.random.default_rng(0), "cpu"),
                       cell.in_shardings)
        with implicit_replication(), FlopCounterMode(display=False) as fc:
            cell.fn(*args)
        out["parity"][(arch, shape)] = (dry["flops"], fc.get_total_flops())
    return out


def analysis_rank(_, cases):
    """For each (arch, shape, changes): analysis.run_cell's extrapolated
    metrics and a direct fake run at full depth, on the (2, 2) mesh."""
    from repro_torch.launch import analysis

    two, _one = _fake_world()
    out = {}
    for arch, shape, changes in cases:
        name = smoke_variant(arch, **changes)
        ext = analysis.run_cell(name, shape, mesh=two, device="cpu")
        direct = analysis._measure(name, shape, two, "cpu")
        out[(arch, shape)] = (ext, direct)
    return out


def one_rank_values_rank(rank, cells):
    """build_cell's fn for each SMOKE (arch, shape) of `cells` on this
    one-rank gloo group's 1 x 1 mesh, its args (numpy weights) laid out
    by the in_shardings, against the same fn on the plain tensors: the
    largest |difference| over the outputs' floating leaves."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed.sharding import tree_leaves
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.train.elastic import reshard

    mesh = make_debug_mesh(device="cpu")
    out = {}
    for arch, shape in cells:
        cell = build_cell(smoke_variant(arch), shape, mesh)
        plain = cell.make_args(np.random.default_rng(1), "cpu")
        with implicit_replication():
            got = cell.fn(*reshard(plain, cell.in_shardings))
        want = cell.fn(*plain)
        diffs = [float((g.full_tensor() if isinstance(g, DTensor) else g)
                       .float().sub(w.float()).abs().max())
                 for g, w in zip(tree_leaves(got), tree_leaves(want))
                 if isinstance(w, torch.Tensor) and w.is_floating_point()]
        out[(arch, shape)] = (len(diffs), max(diffs))
    return out


# ---------------------------------------------------------------------------
# rank bodies: tests/test_torch_launch.py, values on a (2, 2) mesh of 4
# gloo ranks
# ---------------------------------------------------------------------------

def _small_shapes():
    """The LM and vision shapes under their names, cut to SMOKE size:
    batch 4 (1 for long_500k), 16 tokens to train and prefill, a 32- and
    a 64-position cache to decode, 32-pixel images."""
    from repro_torch.configs.base import ShapeSpec

    return {"lm": [
        ShapeSpec("train_4k", "train", seq_len=16, global_batch=4),
        ShapeSpec("prefill_32k", "prefill", seq_len=16, global_batch=4),
        ShapeSpec("decode_32k", "decode", seq_len=32, global_batch=4),
        ShapeSpec("long_500k", "decode", seq_len=64, global_batch=1)],
        "vision": [
        ShapeSpec("cls_224", "train", img_res=32, global_batch=4),
        ShapeSpec("serve_b128", "serve", img_res=32, global_batch=4)]}


def _whole_np(tree):
    """The tree with each tensor as numpy (bf16 as float32, exactly),
    DTensors gathered whole first (a collective: every rank calls it);
    other leaves as they are."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import tree_map_with_path

    def leaf(_, t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        if not isinstance(t, torch.Tensor):
            return t
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree_map_with_path(leaf, tree)


def _random_cache(cache, rng):
    """cache with seeded normals in its tensors (the cache's dtype)."""
    return cache._replace(**{
        f: torch.as_tensor(rng.standard_normal(tuple(t.shape))
                           .astype(np.float32)).to(t.dtype)
        for f, t in zip(cache._fields, cache) if f != "length"})


def mesh_values_rank(rank, cases, moe_case):
    """On a (2, 2) ("data", "model") mesh of the 4 ranks: for each
    (arch, shape, sp_threshold) of `cases`, at the arch's SMOKE config in
    float32 and the shapes of `_small_shapes`, build_cell's fn on its
    args laid out by the in_shardings, beside
    the same fn on plain tensors (every rank runs both, from one seed).
    A decode cell runs on a cache of seeded normals at the cell's
    position and, through its step function, at a position of the
    first `model` rank's half of the cache. `moe_case` = (arch, batch,
    seq, capacity_factor): moe_ffn alone on a batch-sharded x, beside
    the plain layer. Returns {case: (mesh outputs, plain outputs)} as
    numpy on rank 0, None on the others."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import shapes as shapes_mod
    from repro_torch.configs.base import _REGISTRY
    from repro_torch.distributed.sharding import (
        NamedSharding,
        param_shardings,
    )
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import kvcache as kvc
    from repro_torch.models import moe
    from repro_torch.train.elastic import reshard

    shapes_mod.FAMILY_SHAPES.update(_small_shapes())
    mesh = make_debug_mesh(2, 2, device="cpu")
    out = {}

    def both(fn, make):
        """(fn on the args of make() laid out on the mesh, fn on those
        of a second make()), each as numpy."""
        with implicit_replication():
            got = _whole_np(fn(*reshard(make(), shardings)))
        return got, _whole_np(fn(*make()))

    for arch, shape, sp_threshold in cases:
        name = smoke_variant(arch, dtype=torch.float32)
        cell = build_cell(name, shape, mesh, sp_threshold=sp_threshold)
        shardings = cell.in_shardings

        def make(cell=cell):
            args = cell.make_args(np.random.default_rng(5), "cpu")
            if len(args) == 3 and hasattr(args[2], "_fields"):
                args = args[:2] + (_random_cache(
                    args[2], np.random.default_rng(6)),)
            return args
        out[(arch, shape, sp_threshold)] = both(cell.fn, make)
        if "position" in cell.static_kwargs:
            cfg = _REGISTRY[name]
            step = (kvc.mla_decode_step if cfg.mla else
                    kvc.moe_gqa_decode_step if cfg.moe_experts else
                    kvc.gqa_decode_step)
            mid = cell.static_kwargs["position"] // 4
            out[(arch, shape, sp_threshold, mid)] = both(
                lambda p, t, c: step(p, cfg, t, c._replace(length=mid)),
                make)

    arch, b, s, cf = moe_case
    cfg = _REGISTRY[smoke_variant(arch, dtype=torch.float32)]
    p = {"moe": moe.moe_init(np.random.default_rng(7), cfg, device="cpu")}
    x = np.random.default_rng(8).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    shardings = (param_shardings(p, mesh),
                 NamedSharding(mesh, ("data", None, None)))
    out["moe"] = both(
        lambda p, x: moe.moe_ffn(p["moe"], x, cfg, capacity_factor=cf),
        lambda: (p, torch.as_tensor(x)))
    return out if rank == 0 else None
