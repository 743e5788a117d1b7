"""PyTorch operations dispatched per step, counted over a few steps
after the profiled stretch (a TorchDispatchMode counter)."""


def read(ctx):
    return ctx.get("ops_per_step")
