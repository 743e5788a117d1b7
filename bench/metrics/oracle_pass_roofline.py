"""oracle_pass's share of its roofline: launches x the least time of one
launch (its bytes and operations from the cell's shapes) over the
kernel's device time in the profiled stretch, %."""
from bench.harness.costs import bound_s, oracle_pass_cost
from bench.harness.trace import kernel_time


def read(ctx):
    n, seconds = kernel_time(ctx, "oracle_pass")
    if not n:
        return None
    return 100.0 * n * bound_s(*oracle_pass_cost(ctx["dims"])) / seconds
