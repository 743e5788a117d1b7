"""Continual distillation with orientation-balanced replay (paper §3.2).

    python -m repro_torch.examples.continual_distillation [--device cpu]

Simulates the backend's continual-learning loop: the camera keeps
visiting a drifting hotspot, fresh teacher labels arrive only for visited
orientations, and the replay buffer pads neighbors (<=3 hops) so the
student does not catastrophically forget the rest of the grid. Compares
the rank quality of balanced vs naive (fresh-only) retraining.

REPRO_EX_DURATION / REPRO_EX_EVALS shrink the scene and the rank-quality
evaluation.
"""
import argparse
import os

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import DEFAULT_GRID, Query, Workload
from repro_torch.core import continual
from repro_torch.core.distill import spearman, teacher_labels
from repro_torch.data import SceneConfig, build_video, render_image
from repro_torch.fleet.runner import resolve_device
from repro_torch.models import detector as det
from repro_torch.serving import detection_tables
from repro_torch.serving.engine import InferenceEngine

GRID = DEFAULT_GRID
RES = 64


def make_batch(video, tables, samples, cfg, dev):
    imgs, bxs, cls, vld = [], [], [], []
    for (t, c) in samples:
        imgs.append(render_image(video.snapshots[t], GRID, c, 1.0, res=RES))
        d = tables[("yolov4", "person")].dets[1.0][t][c]
        tgt = teacher_labels([d["boxes"]], [np.zeros(len(d["boxes"]), int)],
                             cfg.max_boxes)
        bxs.append(tgt.boxes[0])
        cls.append(tgt.classes[0])
        vld.append(tgt.valid[0])
    return tuple(torch.as_tensor(np.stack(x), device=dev)
                 for x in (imgs, bxs, cls, vld))


def rank_quality(params, cfg, video, tables, rng, dev,
                 n_eval=int(os.environ.get("REPRO_EX_EVALS", "40"))):
    """Spearman correlation between the network's counts and the
    teacher's across random orientation sets."""
    engine = InferenceEngine(cfg, params, dev)
    rhos = []
    for _ in range(n_eval):
        t = int(rng.integers(0, video.n_frames))
        cells = rng.choice(GRID.n_cells, 6, replace=False)
        true = np.array([tables[("yolov4", "person")].dets[1.0][t][int(c)]
                         ["count"] for c in cells], float)
        if true.max() == 0:
            continue
        imgs = np.stack([render_image(video.snapshots[t], GRID, int(c),
                                      1.0, res=RES) for c in cells])
        counts, _ = engine.counts_and_areas(imgs)
        rhos.append(spearman(counts.cpu().numpy().astype(float), true))
    return float(np.mean(rhos))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config("madeye-approx")
    workload = Workload((Query("yolov4", "person", "count"),))
    print("building scene...")
    video = build_video(GRID, SceneConfig(fps=15, seed=21),
                        float(os.environ.get("REPRO_EX_DURATION", "10.0")))
    tables = detection_tables(video, workload)

    # visit trace: the camera dwells hard on two cells (severe imbalance —
    # the paper's 9.3%-coverage regime)
    visit_trace = []
    for t in range(0, video.n_frames, 2):
        visit_trace.append((t, 12 if (t // 30) % 2 == 0 else 13))

    for mode in ("balanced", "naive"):
        params = det.detector_init(torch.Generator().manual_seed(0), cfg,
                                   dev)
        opt = continual.init_finetune(params)
        buffer = continual.ReplayBuffer(GRID.n_cells)
        # bootstrap history: the paper's initial fine-tuning set covers
        # every orientation — that is what balanced replay pads from
        for c0 in range(GRID.n_cells):
            for tb in (0, 5, 10):
                buffer.add(c0, (tb, c0))
        window_counts = np.zeros(GRID.n_cells, int)
        trained_cells = set()
        for (t, c) in visit_trace:
            buffer.add(c, (t, c))
            window_counts[c] += 1
            if t % 15 != 0:
                continue
            if mode == "balanced":
                samples = continual.sample_balanced(
                    buffer, window_counts, c, GRID, max_total=16)
            else:
                samples = buffer.recent(c, 16)
            if not samples:
                continue
            trained_cells.update(cc for (_, cc) in samples)
            batch = make_batch(video, tables, samples, cfg, dev)
            for _ in range(3):
                params, opt, loss = continual.finetune_step(
                    params, opt, cfg, *batch, lr=3e-3)
            window_counts[:] = 0
        rho = rank_quality(params, cfg, video, tables,
                           np.random.default_rng(1), dev)
        print(f"{mode:>9} replay: rank quality (Spearman) = {rho:+.3f}  "
              f"(trained on {len(trained_cells)}/{GRID.n_cells} "
              f"orientations)")


if __name__ == "__main__":
    main()
