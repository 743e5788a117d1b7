"""Device idle time inside the `madeye/backbone` spans of each
`madeye/step`: the card waiting on the host while the detector backbone
is dispatched, per step of the profiled stretch, ms."""
from bench.harness.backbone_spans import backbone_metric


def read(ctx):
    return backbone_metric(ctx, "backbone_idle_ms")
