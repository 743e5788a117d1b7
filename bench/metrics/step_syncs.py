"""CUDA calls that synchronise the host with the device (names starting
`cuda` and holding `Synchronize`, e.g. the `cudaStreamSynchronize` of a
blocking copy) that start inside a `madeye/step` span, per step of the
profiled stretch."""
from bench.harness.spans import phase_metric


def read(ctx):
    return phase_metric(ctx, "step_syncs")
