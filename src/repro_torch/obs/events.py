"""Streaming episode events: FleetResult -> JSONL telemetry.

A fleet episode becomes a stream of JSON-lines events a dashboard /
alerting client can tail (`serve --fleet N --telemetry PATH|-`).
Device->host transfer is amortized by slicing the episode's stacked
`[E, ...]` output tensors in chunks of steps — one `.cpu()` copy per
chunk per leaf, never per step. The schema is the reference package's,
event for event.

Schema (one JSON object per line, `schema` = SCHEMA_VERSION on every
event; `validate_event` pins the required keys):

  {"event": "run_start", "schema": 1, "spec": {...FleetRunSpec...},
   "n_cameras": F, "n_steps": E, "metrics": true|false}

  {"event": "steps", "schema": 1, "step0": s, "step1": s+k,
   "acc_mean": float,            # fleet-mean oracle acc over the chunk
   "frames_sent": int,           # fleet-wide frames shipped in the chunk
   "cameras": {                  # per-camera health summary, [F] lists
      "acc_mean": [...], "frames_sent": [...], "n_explored_mean": [...],
      "health": ["ok"|"idle"|"lagging", ...],
      # with FleetMetrics enabled on the run, additionally:
      "ewma_label": [...], "shortlist_hit_rate": [...],
      "chosen_rank_median": [...],
      # and on distillation runs (FleetRunSpec.distill, learn/):
      "distill_loss": [...], "distill_lr": [...]}}

  {"event": "run_end", "schema": 1, "accuracy": float,
   "frames_sent_total": int, "timings": {...},
   "camera_steps_per_s": float, "metrics_summary": {...}|null}

Health classification (documented, deterministic): a camera is "idle"
when it shipped no frame in the chunk, "lagging" when its chunk-mean
oracle accuracy falls below half the fleet chunk mean, else "ok".
"""
from __future__ import annotations

import dataclasses
import json
import sys

import numpy as np

from repro_torch.obs.metrics import _host, median_valid_rank, summarize_metrics

SCHEMA_VERSION = 1

REQUIRED_KEYS = {
    "run_start": ("schema", "spec", "n_cameras", "n_steps", "metrics"),
    "steps": ("schema", "step0", "step1", "acc_mean", "frames_sent",
              "cameras"),
    "run_end": ("schema", "accuracy", "frames_sent_total", "timings",
                "camera_steps_per_s", "metrics_summary"),
}
_CAMERA_KEYS = ("acc_mean", "frames_sent", "n_explored_mean", "health")


def validate_event(ev: dict) -> dict:
    """Raise ValueError unless `ev` carries its event type's required
    keys (steps events additionally pin the per-camera summary keys).
    Returns the event for chaining."""
    kind = ev.get("event")
    if kind not in REQUIRED_KEYS:
        raise ValueError(f"unknown event type {kind!r}; expected one of "
                         f"{sorted(REQUIRED_KEYS)}")
    missing = [k for k in REQUIRED_KEYS[kind] if k not in ev]
    if kind == "steps":
        missing += [f"cameras.{k}" for k in _CAMERA_KEYS
                    if k not in ev.get("cameras", {})]
    if missing:
        raise ValueError(f"{kind} event missing keys: {missing}")
    return ev


def _health(acc_mean: np.ndarray, sent: np.ndarray) -> list:
    fleet = float(acc_mean.mean())
    out = []
    for a, s in zip(acc_mean, sent):
        if s == 0:
            out.append("idle")
        elif fleet > 0 and a < 0.5 * fleet:
            out.append("lagging")
        else:
            out.append("ok")
    return out


def episode_events(result, *, chunk: int = 16):
    """Yield telemetry events for a completed fleet episode.

    `result` is a repro_torch.fleet.FleetResult that still carries its
    device outputs (`result.out` — run_fleet's return does; a JSON-round-
    tripped result does not and raises). Chunking slices the stacked
    [E, ...] tensors `chunk` steps at a time, so each leaf incurs one
    device->host copy per chunk."""
    if result.out is None:
        raise ValueError("episode_events needs the device outputs; this "
                         "FleetResult was stripped (JSON round trip?)")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    e, f = result.n_steps, result.n_cameras
    metrics = getattr(result, "metrics", None)
    try:
        if any(isinstance(v, dict) and not all(
                isinstance(k, (str, int, float, bool, type(None)))
                for k in v) for v in result.spec.provider_kwargs.values()):
            # keys JSON refuses (the tables' (model, obj) tuples): fail
            # before serializing a whole prebuilt Video ahead of them
            raise TypeError("provider kwargs with non-JSON keys")
        spec_json = json.loads(result.spec.to_json())
    except TypeError:
        # specs built from in-memory objects (the tables provider's
        # prebuilt video/tables/trace ride through provider_kwargs)
        # aren't JSON-round-trippable — telemetry still names them
        stripped = dataclasses.replace(result.spec, provider_kwargs={})
        spec_json = json.loads(stripped.to_json())
        spec_json["provider_kwargs"] = {
            k: f"<in-memory {type(v).__name__}>"
            for k, v in result.spec.provider_kwargs.items()}
    yield validate_event({
        "event": "run_start", "schema": SCHEMA_VERSION,
        "spec": spec_json,
        "n_cameras": f, "n_steps": e, "metrics": metrics is not None})

    for s0 in range(0, e, chunk):
        s1 = min(s0 + chunk, e)
        # one device->host copy per leaf per chunk
        acc = _host(result.out.acc_chosen[s0:s1]).astype(np.float32)
        sent = _host(result.out.sent[s0:s1])
        nexp = _host(result.out.n_explored[s0:s1]).astype(np.float32)
        cam_acc = acc.mean(0)
        cam_sent = sent.sum((0, 2)).astype(int)
        cameras = {
            "acc_mean": [round(float(a), 4) for a in cam_acc],
            "frames_sent": cam_sent.tolist(),
            "n_explored_mean": [round(float(x), 2) for x in nexp.mean(0)],
            "health": _health(cam_acc, cam_sent),
        }
        if metrics is not None:
            if "ewma_label_mean" in metrics:
                lab = _host(metrics["ewma_label_mean"][s1 - 1])
                cameras["ewma_label"] = [round(float(x), 4) for x in lab]
            if "shortlist_hit" in metrics:
                hit = _host(metrics["shortlist_hit"][s0:s1])
                cameras["shortlist_hit_rate"] = [
                    round(float(x), 4) for x in hit.mean(0)]
            if "chosen_rank" in metrics:
                rank = _host(metrics["chosen_rank"][s0:s1])
                cameras["chosen_rank_median"] = [
                    median_valid_rank(rank[:, fi]) for fi in range(f)]
            if "distill_loss" in metrics:
                # learning runs — per-camera mean loss over this
                # chunk's actual updates (-1.0 = none)
                loss = _host(metrics["distill_loss"][s0:s1]).astype(
                    np.float32)
                upd = loss >= 0.0
                cameras["distill_loss"] = [
                    round(float((loss[:, fi] * upd[:, fi]).sum()
                                / max(upd[:, fi].sum(), 1))
                          if upd[:, fi].any() else -1.0, 5)
                    for fi in range(f)]
                lr = _host(metrics["distill_lr"][s1 - 1])
                cameras["distill_lr"] = [
                    round(float(x), 6) for x in lr]
        yield validate_event({
            "event": "steps", "schema": SCHEMA_VERSION,
            "step0": s0, "step1": s1,
            "acc_mean": round(float(acc.mean()), 4),
            "frames_sent": int(sent.sum()),
            "cameras": cameras})

    yield validate_event({
        "event": "run_end", "schema": SCHEMA_VERSION,
        "accuracy": result.accuracy,
        "frames_sent_total": int(sum(result.frames_sent)),
        "timings": result.timings,
        "camera_steps_per_s": result.camera_steps_per_s,
        "metrics_summary": (None if metrics is None
                            else summarize_metrics(metrics))})


def write_events(events, path: str) -> int:
    """Write an event iterable as JSON lines to `path` ("-" = stdout;
    files are opened in append mode — telemetry is a log). Returns the
    number of events written."""
    n = 0
    if path == "-":
        for ev in events:
            sys.stdout.write(json.dumps(ev) + "\n")
            n += 1
        sys.stdout.flush()
        return n
    with open(path, "a") as fh:
        for ev in events:
            fh.write(json.dumps(ev) + "\n")
            n += 1
    return n


def read_events(path: str) -> list:
    """Load + validate a telemetry JSONL file back into event dicts."""
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(validate_event(json.loads(line)))
    return out
