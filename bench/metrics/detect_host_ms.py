"""Host time of the `madeye/detect` span, the shortlist, `crop_patchify`,
the detector forward (or the per-camera heads when distilling) and the
tables (`detections_obs`), per step of the profiled stretch, ms."""
from bench.harness.spans import phase_metric


def read(ctx):
    return phase_metric(ctx, "detect_host_ms")
