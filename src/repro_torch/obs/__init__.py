"""Fleet telemetry: the in-episode device metrics (`metrics.py`,
`MetricsSpec`-gated FleetMetrics — shortlist hit-rate, chosen-vs-oracle
rank, EWMA labels, budget counters — per-step [E, F] outputs, zero cost
when off)."""
from repro_torch.obs.metrics import (
    METRIC_KEYS,
    MetricsSpec,
    median_valid_rank,
    normalize_metrics,
    step_metrics,
    summarize_metrics,
)

__all__ = [
    "METRIC_KEYS",
    "MetricsSpec",
    "median_valid_rank",
    "normalize_metrics",
    "step_metrics",
    "summarize_metrics",
]
