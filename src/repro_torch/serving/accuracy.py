"""Ground-truth accuracy computation (paper §2.1 metrics, §5.1 methodology).

Per-frame, per-orientation accuracy is *relative to the best orientation at
that instant* — e.g. a counting query's accuracy at a cell is its detected
count over the max detected count across all (cell, zoom) orientations.
Detection queries consolidate boxes across orientations into a global view,
de-duplicate by object identity (the oracle teachers report it), and
score each orientation's mAP proxy against that global set.

Aggregate counting is evaluated once per video: unique object ids captured
by the frames a scheme shipped vs unique ids present in the whole video.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.rank import Workload
from repro_torch.data.dataset import OBJ_IDS, Video
from repro_torch.serving.teachers import TEACHERS, run_teacher


@dataclass
class DetectionTable:
    """dets[z][t][cell] -> teacher output dict for one (model, obj)."""
    model: str
    obj: str
    dets: dict


def detection_tables(video: Video, workload: Workload,
                     zoom_levels=(1.0, 2.0, 3.0)) -> dict:
    """Precompute teacher detections for every query x (t, cell, zoom)."""
    tables = {}
    for q in workload.queries:
        key = (q.model, q.obj)
        if key in tables:
            continue
        prof = TEACHERS[q.model]
        cls = OBJ_IDS[q.obj]
        dets = {}
        for z in zoom_levels:
            per_t = []
            for t in range(video.n_frames):
                row = []
                for c in range(video.grid.n_cells):
                    gt = dict(video.gt_zoom[z][t][c])
                    gt["cell"] = c
                    row.append(run_teacher(prof, gt, t, cls))
                per_t.append(row)
            dets[z] = per_t
        tables[key] = DetectionTable(q.model, q.obj, dets)
    return tables


# ---------------------------------------------------------------------------
# Per-task relative accuracy tables: acc[t, cell, zoom]
# ---------------------------------------------------------------------------

def _counts(table: DetectionTable, t: int, zoom_levels) -> np.ndarray:
    return np.array([[table.dets[z][t][c]["count"]
                      for z in zoom_levels]
                     for c in range(len(table.dets[zoom_levels[0]][t]))])


def query_acc_table(video: Video, table: DetectionTable, task: str,
                    zoom_levels=(1.0, 2.0, 3.0)) -> np.ndarray:
    """[T, n_cells, n_zoom] relative accuracy for a frame-level task."""
    T = video.n_frames
    N = video.grid.n_cells
    Z = len(zoom_levels)
    acc = np.zeros((T, N, Z))
    for t in range(T):
        counts = _counts(table, t, zoom_levels)          # [N, Z]
        if task == "binary":
            if counts.max() == 0:
                acc[t] = 1.0          # correct "no" everywhere
            else:
                acc[t] = (counts > 0).astype(float)
        elif task in ("count", "agg_count"):
            m = counts.max()
            acc[t] = counts / m if m > 0 else 1.0
        elif task == "detect":
            # global de-duplicated detected set (ids from oracle teachers;
            # fp ids < 0 are excluded from the global set)
            global_ids = set()
            quality = np.zeros((N, Z))
            rec = np.zeros((N, Z))
            for c in range(N):
                for zi, z in enumerate(zoom_levels):
                    d = table.dets[z][t][c]
                    global_ids.update(int(i) for i in d["ids"] if i >= 0)
            for c in range(N):
                for zi, z in enumerate(zoom_levels):
                    d = table.dets[z][t][c]
                    found = {int(i) for i in d["ids"] if i >= 0}
                    rec[c, zi] = (len(found) / len(global_ids)
                                  if global_ids else 1.0)
                    quality[c, zi] = d["quality"]
            score = rec * quality
            m = score.max()
            acc[t] = score / m if m > 0 else 1.0
        else:
            raise ValueError(task)
    return acc


def workload_acc_table(video: Video, workload: Workload, tables: dict,
                       zoom_levels=(1.0, 2.0, 3.0)) -> np.ndarray:
    """[T, n_cells, n_zoom] mean relative accuracy over the workload's
    frame-level queries (aggregate counting is video-level: evaluated by
    `aggregate_count_accuracy`, its table contribution uses the count
    proxy as in §2.1)."""
    acc = None
    for q in workload.queries:
        t = query_acc_table(video, tables[(q.model, q.obj)], q.task,
                            zoom_levels)
        acc = t if acc is None else acc + t
    return acc / len(workload.queries)


# ---------------------------------------------------------------------------
# Aggregate counting (video-level) + end-to-end selection scoring
# ---------------------------------------------------------------------------

def aggregate_count_accuracy(video: Video, table: DetectionTable,
                             visited: dict, zoom_levels=(1.0, 2.0, 3.0)
                             ) -> float:
    """visited: {frame_idx: [(cell, zoom_idx), ...]} actually shipped.

    Accuracy = |unique detected ids over shipped frames| / |unique ids
    detectable anywhere in the whole video by this teacher| (§5.1)."""
    total_ids, got_ids = set(), set()
    for t in range(video.n_frames):
        for c in range(video.grid.n_cells):
            for z in zoom_levels:
                total_ids.update(
                    int(i) for i in table.dets[z][t][c]["ids"] if i >= 0)
    for t, sent in visited.items():
        for (c, zi) in sent:
            z = zoom_levels[zi]
            got_ids.update(
                int(i) for i in table.dets[z][t][c]["ids"] if i >= 0)
    if not total_ids:
        return 1.0
    return len(got_ids) / len(total_ids)


def evaluate_selection(video: Video, workload: Workload, tables: dict,
                       visited: dict, zoom_levels=(1.0, 2.0, 3.0)) -> float:
    """Workload accuracy for an arbitrary selection scheme.

    visited: {frame_idx: [(cell, zoom_idx), ...]} shipped at each
    *response* frame (the response rate subsamples the video rate).
    Frame-level queries score the best shipped orientation per response
    frame (the backend keeps the max); aggregate counting scores once per
    video.
    """
    frames = sorted(visited)
    per_query = []
    for q in workload.queries:
        table = tables[(q.model, q.obj)]
        if q.task == "agg_count":
            per_query.append(
                aggregate_count_accuracy(video, table, visited, zoom_levels))
            continue
        acc = query_acc_table(video, table, q.task, zoom_levels)
        vals = []
        for t in frames:
            sent = visited[t]
            if not sent:
                vals.append(0.0)
                continue
            vals.append(max(acc[t, c, zi] for (c, zi) in sent))
        per_query.append(float(np.mean(vals)) if vals else 0.0)
    return float(np.mean(per_query))
