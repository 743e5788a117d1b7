"""Fleet telemetry: in-episode device metrics, host traces, event streams.

  metrics.py  `MetricsSpec`-gated FleetMetrics computed inside the
              episode (shortlist hit-rate, chosen-vs-oracle rank, EWMA
              labels, budget counters) — per-step [E, F] tensors on the
              device, zero cost when off
  trace.py    host span API -> Chrome trace JSON (build / warm-up /
              steady-state phases; chrome://tracing, Perfetto) with
              optional NVTX ranges
  events.py   FleetResult -> chunked JSONL event stream with per-camera
              health summaries (`serve --fleet N --telemetry PATH|-`)

This package never imports repro_torch.fleet at module scope (the runner
imports metrics into the step), so it stays import-cycle-free.
"""
from repro_torch.obs.metrics import (
    METRIC_KEYS,
    MetricsSpec,
    median_valid_rank,
    normalize_metrics,
    step_metrics,
    summarize_metrics,
)
from repro_torch.obs.trace import (
    Tracer,
    activate,
    active_tracer,
    deactivate,
    span,
    tracing,
)
from repro_torch.obs.events import (
    SCHEMA_VERSION,
    episode_events,
    read_events,
    validate_event,
    write_events,
)

__all__ = [
    "METRIC_KEYS",
    "MetricsSpec",
    "median_valid_rank",
    "normalize_metrics",
    "step_metrics",
    "summarize_metrics",
    "Tracer",
    "activate",
    "active_tracer",
    "deactivate",
    "span",
    "tracing",
    "SCHEMA_VERSION",
    "episode_events",
    "read_events",
    "validate_event",
    "write_events",
]
