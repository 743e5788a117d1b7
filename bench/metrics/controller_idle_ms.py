"""Device idle time inside the `madeye/controller` span, the controller
step (`fleet_step`), per step of the profiled stretch, ms."""
from bench.harness.spans import phase_metric


def read(ctx):
    return phase_metric(ctx, "controller_idle_ms")
