"""Share of the profiled stretch with no kernel, copy or fill running on
the device, %."""


def read(ctx):
    if not ctx.get("trace_window_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace_window_s"])
