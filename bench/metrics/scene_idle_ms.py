"""Device idle time inside the `madeye/scene` span, the scene advance and
the oracle pass (`SceneProvider.oracle`), per step of the profiled
stretch, ms."""
from bench.harness.spans import phase_metric


def read(ctx):
    return phase_metric(ctx, "scene_idle_ms")
