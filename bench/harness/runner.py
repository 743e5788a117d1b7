"""One run of one cell: set-up, the timed window, with `trace` the
profiled stretch and the op count, then the comparison; -> the result
line's object and the comparison's lines for standard error."""
from __future__ import annotations

import subprocess
import time

import torch

from bench.harness.cell import Cell, load_file
from bench.harness.check import compare, judge
from bench.harness.program import Run
from bench.harness.trace import breakdown, busy_idle, count_ops, profile_steps
from bench.harness.weights import make_weights
from bench.reference import episode as ref
from bench.reference.grid import OrientationGrid


def read_metric(root, name: str, ctx: dict):
    """The reader `bench/metrics/<name>.py` applied to ctx (None: nothing
    to read)."""
    return load_file(root / "bench" / "metrics" / f"{name}.py",
                     "metric").read(ctx)


def dims(cell: Cell) -> dict:
    """The cell's shapes, as the cost functions and readers take them."""
    t = cell.traffic
    grid = OrientationGrid(**t["grid"])
    pairs = {(m, o) for m, o, _ in t["workload"]}
    return {"model": cell.model, "sizes": cell.sizes,
            "n_cameras": t["n_cameras"], "shortlist_k": t["shortlist_k"],
            "n_objects": t["scene"]["max_people"] + t["scene"]["max_cars"],
            "n_pairs": len(pairs), "n_queries": len(t["workload"]),
            "n_windows": grid.n_orientations, "distill": cell.distill}


def power_limit() -> str | None:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False) -> tuple[dict, list]:
    from repro_torch.models.layers import full_float32

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    # where set-up's seconds go: imports, the device's context with the
    # weights, the fleet prepared, the warm-up step
    marks = [("imports", time.perf_counter())]
    weights = make_weights(cell.model.leaves(cell.sizes), seed, dev)
    marks.append(("context_and_weights", time.perf_counter()))
    run = Run(cell, weights, seed, seconds, dev)
    marks.append(("prepare", time.perf_counter()))
    ctx = {"dims": dims(cell)}
    with full_float32(), torch.no_grad():
        run.warm_up()
        marks.append(("warm_up", time.perf_counter()))
        ctx["setup_s"] = marks[-1][1] - t_start
        w = run.window(seconds)
        ctx["window"] = w
        ctx["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda \
            else 0
        if trace:
            tr = profile_steps(run)
            ctx["busy_s"], ctx["trace_window_s"], gaps = busy_idle(tr)
            ctx["trace"] = tr
            ctx["ops_per_step"] = count_ops(run)
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = read_metric(cell.root, m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the comparison, on weights made again from the seed
    ref_weights = make_weights(cell.model.leaves(cell.sizes), seed, dev)
    world = ref.build_world(cell.model, cell.sizes, cell.traffic, seed,
                            dev, cell.distill)
    worst, per_step = compare(run, world, ref_weights, w.sampled, control)
    run.free()
    limits = cell.limits["limits"]
    correct, checks = judge(worst, limits)
    failed = sum(not judge(n, limits)[0] for n in per_step)
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": (torch.cuda.get_device_name(dev) if cuda
                            else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": ctx["peak_bytes"]}
    if cuda:
        device_info["power_limit"] = power_limit()
    if trace:
        device_info["busy_s"] = ctx["busy_s"]
        device_info["window_s"] = ctx["trace_window_s"]
    result = {"correct": correct, "attempted": w.steps, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        result["breakdown"] = breakdown(ctx["trace"], gaps)
    starts = [t_start] + [t for _, t in marks[:-1]]
    result["setup_parts"] = {name: t - t0 for (name, t), t0
                             in zip(marks, starts)}
    if control:
        result["numbers"] = worst
    result["checks"] = checks
    lines = [f"check {k}: {v['value']} limit {v['limit']}"
             for k, v in checks.items()]
    return result, lines
