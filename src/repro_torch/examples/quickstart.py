"""Quickstart: MadEye vs the oracle baselines on a procedural scene.

    python -m repro_torch.examples.quickstart

Builds a 15-second scene, registers a 4-query workload (the paper's
{model, object, task} triples), runs the full MadEye loop at 5 fps over a
{24 Mbps, 20 ms} link, and prints workload accuracy against the oracle
fixed/dynamic baselines. Host numpy only (core, data, serving): it runs
no tensor, so it takes no device.

Set REPRO_EX_DURATION to shrink the scene.
"""
import os
import time

from repro_torch.core import DEFAULT_GRID, Query, Workload
from repro_torch.core.tradeoff import BudgetConfig
from repro_torch.data import SceneConfig, build_video
from repro_torch.serving import (
    NetworkTrace,
    detection_tables,
    run_madeye,
    run_scheme,
    workload_acc_table,
)


def main():
    workload = Workload((
        Query("yolov4", "person", "count"),
        Query("frcnn", "car", "detect"),
        Query("ssd", "person", "binary"),
        Query("tiny-yolov4", "person", "agg_count"),
    ))

    duration = float(os.environ.get("REPRO_EX_DURATION", "15.0"))
    print("building scene + teacher detection tables...")
    t0 = time.time()
    video = build_video(DEFAULT_GRID, SceneConfig(fps=15, seed=42), duration)
    tables = detection_tables(video, workload)
    acc = workload_acc_table(video, workload, tables)
    print(f"  done in {time.time()-t0:.1f}s "
          f"({video.n_frames} frames x {DEFAULT_GRID.n_cells} cells "
          f"x 3 zooms)")

    budget = BudgetConfig(fps=5.0)
    trace = NetworkTrace.fixed(24, 20, video.n_frames)

    res = run_madeye(video, workload, tables, budget, trace, acc_table=acc)
    print(f"\nMadEye        : accuracy {res.accuracy:.3f} "
          f"(shape {res.mean_shape:.1f} cells/step, "
          f"{res.frames_sent/len(res.visited):.1f} frames shipped/step, "
          f"best orientation explored {res.best_explored_rate*100:.0f}%)")

    for scheme in ("one_time_fixed", "best_fixed", "best_dynamic"):
        r = run_scheme(video, workload, tables, scheme, budget=budget,
                       acc_table=acc)
        marker = " <- oracle" if "dynamic" in scheme or "best" in scheme \
            else ""
        print(f"{scheme:14s}: accuracy {r.accuracy:.3f}{marker}")


if __name__ == "__main__":
    main()
