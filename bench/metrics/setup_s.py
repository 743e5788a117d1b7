"""Seconds from the process's start to the first timed step: imports,
the device's context, the kernel library, the weights, the fleet
prepared, the warm-up step (host clock)."""


def read(ctx):
    return ctx["setup_s"]
