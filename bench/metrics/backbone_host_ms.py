"""Host time of the `madeye/backbone` spans inside `madeye/step`: the
detector backbone's forward over the step's crops (the Swin stages and
their last two maps' norms, or the ViT), per step of the profiled
stretch, ms."""
from bench.harness.backbone_spans import backbone_metric


def read(ctx):
    return backbone_metric(ctx, "backbone_host_ms")
