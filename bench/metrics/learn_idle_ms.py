"""Device idle time inside the `madeye/learn` span, the learning hook
(`DetectorProvider.learn`: teacher targets, ring harvest, optimizer
step); distilling runs only, per step of the profiled stretch, ms."""
from bench.harness.spans import phase_metric


def read(ctx):
    return phase_metric(ctx, "learn_idle_ms")
