"""End-to-end adaptive serving with the neural approximation model.

    python -m repro_torch.examples.adaptive_serving [--device cpu]

Drives the detector network through the batched InferenceEngine: every
timestep the explored orientations are rendered to images, scored by
the network in ONE batch (serving/engine.py), ranked, and the top-k
shipped. The detector is first distilled from the yolov4 teacher for a
few steps (core/continual.finetune_step) so its counts are meaningful.

REPRO_EX_DURATION / REPRO_EX_STEPS shrink the scene and the
distillation phase.
"""
import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import DEFAULT_GRID, MadEyeController, Observation, \
    Query, Workload
from repro_torch.core import continual
from repro_torch.core.distill import teacher_labels
from repro_torch.core.tradeoff import BudgetConfig
from repro_torch.data import SceneConfig, boxes_to_scene, build_video, \
    render_image
from repro_torch.fleet.runner import resolve_device
from repro_torch.models import detector as det
from repro_torch.serving import NetworkTrace, detection_tables, \
    evaluate_selection, workload_acc_table
from repro_torch.serving.engine import InferenceEngine

GRID = DEFAULT_GRID
RES = 64


def distill_detector(cfg, video, tables, dev,
                     steps=int(os.environ.get("REPRO_EX_STEPS", "100"))):
    """Bootstrap fine-tuning (paper §3.2 initial phase, abbreviated)."""
    params = det.detector_init(torch.Generator().manual_seed(0), cfg, dev)
    opt = continual.init_finetune(params)
    rng = np.random.default_rng(0)
    print("  distilling detector from yolov4 teacher...")
    for step in range(steps):
        ts = rng.integers(0, video.n_frames, 8)
        cells = rng.integers(0, GRID.n_cells, 8)
        imgs, bxs, cls, vld = [], [], [], []
        for t, c in zip(ts, cells):
            imgs.append(render_image(video.snapshots[t], GRID, int(c), 1.0,
                                     res=RES))
            d = tables[("yolov4", "person")].dets[1.0][t][int(c)]
            tgt = teacher_labels([d["boxes"]],
                                 [np.zeros(len(d["boxes"]), int)],
                                 cfg.max_boxes)
            bxs.append(tgt.boxes[0])
            cls.append(tgt.classes[0])
            vld.append(tgt.valid[0])
        params, opt, loss = continual.finetune_step(
            params, opt, cfg,
            *(torch.as_tensor(np.stack(x), device=dev)
              for x in (imgs, bxs, cls, vld)), lr=3e-3)
        if step % 25 == 0:
            print(f"    step {step:3d} distill loss {float(loss):.3f}")
    return params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    workload = Workload((Query("yolov4", "person", "count"),))
    cfg = get_smoke_config("madeye-approx")

    print("building scene...")
    video = build_video(GRID, SceneConfig(fps=15, seed=13),
                        float(os.environ.get("REPRO_EX_DURATION", "8.0")))
    tables = detection_tables(video, workload)
    acc = workload_acc_table(video, workload, tables)

    params = distill_detector(cfg, video, tables, dev)
    engine = InferenceEngine(cfg, params, dev)

    ctrl = MadEyeController(GRID, workload, budget=BudgetConfig(fps=1.0))
    trace = NetworkTrace.fixed(24, 20, video.n_frames)
    visited = {}
    stride = video.fps  # 1 fps response rate

    print("serving (NN approximation model in the loop)...")
    t0 = time.time()
    for t in range(0, video.n_frames, stride):
        ctrl.report_network(trace.observed_mbps(t), trace.rtt_s)
        snap = video.snapshots[t]

        def observe(cells, zooms, _t=t, _snap=snap):
            if not cells:
                return []
            imgs = np.stack([
                render_image(_snap, GRID, int(c), (1.0, 2.0, 3.0)[int(z)],
                             res=RES)
                for c, z in zip(cells, zooms)])
            d = engine.score_batch(imgs)
            scores = d.scores.cpu().numpy()
            all_boxes = d.boxes.cpu().numpy()
            obs = []
            for i, (c, z) in enumerate(zip(cells, zooms)):
                keep = scores[i] >= 0.3
                boxes = all_boxes[i][keep]
                n = int(keep.sum())
                if n:
                    centers, sizes = boxes_to_scene(
                        boxes, GRID, int(c), (1.0, 2.0, 3.0)[int(z)])
                else:
                    centers = np.zeros((0, 2))
                    sizes = np.zeros((0, 2))
                obs.append(Observation(
                    counts={("yolov4", "person"): n},
                    areas={("yolov4", "person"):
                           float((boxes[:, 2] * boxes[:, 3]).sum())
                           if n else 0.0},
                    centroid=centers.mean(0) if n else np.zeros(2),
                    has_boxes=n > 0, box_centers=centers,
                    box_sizes=sizes))
            return obs

        res = ctrl.step(observe)
        zoom_of = {c: int(z) for c, z in zip(res.explored, res.zooms)}
        visited[t] = [(c, zoom_of[c]) for c in res.sent]

    accuracy = evaluate_selection(video, workload, tables, visited)
    n_steps = len(visited)
    print(f"  {n_steps} timesteps in {time.time()-t0:.1f}s "
          f"({(time.time()-t0)/n_steps*1e3:.0f} ms/step, detector on "
          f"{dev.type})")
    print(f"\nNN-in-the-loop MadEye accuracy: {accuracy:.3f}")
    T, N, Z = acc.shape
    best_fixed = float(acc.reshape(T, N * Z).mean(0).max())
    print(f"(oracle best-fixed accuracy on the same scene: {best_fixed:.3f};"
          " the gap is the 100-step smoke detector's ranking noise)")


if __name__ == "__main__":
    main()
