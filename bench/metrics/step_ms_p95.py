"""The 95th percentile of the window's step times in milliseconds, each
step timed from its start to its decisions on the host."""
import statistics


def read(ctx):
    step_s = ctx["window"].step_s
    if len(step_s) < 2:
        return None
    return statistics.quantiles(step_s, n=20)[18] * 1e3
