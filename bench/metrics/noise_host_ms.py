"""Host time of the `madeye/noise` span, the render noise (`render_noise`),
per step of the profiled stretch, ms."""
from bench.harness.spans import phase_metric


def read(ctx):
    return phase_metric(ctx, "noise_host_ms")
