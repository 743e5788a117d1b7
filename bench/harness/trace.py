"""The traced run's readings: a profiled stretch of steps after the
timed window (device activity from torch.profiler), and the PyTorch
operations of a few steps after that (a dispatch-mode counter, never
inside a profiled or timed stretch)."""
from __future__ import annotations

import time
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode

TRACE_SECONDS = 2.0         # the profiled stretch: whole steps past this
TRACE_MIN_STEPS = 3
COUNT_STEPS = 2             # steps under the op counter


class OpCounter(TorchDispatchMode):
    """Counts every PyTorch operation dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def count_ops(run, n_steps: int = COUNT_STEPS) -> float:
    """PyTorch operations per step over `n_steps` further steps."""
    with OpCounter() as counter:
        run.more(n_steps)
    return counter.n / n_steps


def _interval_union(spans: list) -> list:
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_steps(run) -> dict:
    """Profile whole steps until TRACE_SECONDS have passed; -> the device
    events and the host operations, each (name, start_ns, end_ns), and
    the stretch's steps."""
    from torch.profiler import ProfilerActivity, profile

    run.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = 0
        while n < TRACE_MIN_STEPS or time.perf_counter() - t0 < TRACE_SECONDS:
            run.more(1)
            n += 1
        run.sync()
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        span = (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            device.append(span)
        elif ev.device_type() == torch.autograd.DeviceType.CPU:
            host.append(span)
    return {"device": device, "host": host, "steps": n}


def busy_idle(tr: dict) -> tuple[float, float, list]:
    """(busy seconds, window seconds, idle gaps [(start, end)] in ns) of
    the profiled stretch. The window runs from its first host or device
    activity to its last; busy is the union of device activity."""
    spans = [(a, b) for _, a, b in tr["device"]]
    ends = spans + [(a, b) for _, a, b in tr["host"]]
    if not spans:
        return 0.0, 0.0, []
    lo = min(a for a, _ in ends)
    hi = max(b for _, b in ends)
    u = _interval_union(spans)
    busy = sum(b - a for a, b in u)
    gaps = [(lo, u[0][0])] + [(u[i][1], u[i + 1][0])
                              for i in range(len(u) - 1)] + [(u[-1][1], hi)]
    return busy / 1e9, (hi - lo) / 1e9, [g for g in gaps if g[1] > g[0]]


def breakdown(tr: dict, gaps: list) -> dict:
    """The device operations that took most time and the longest idle
    gaps, each gap named by the innermost host operation running at its
    middle."""
    per_op = Counter()
    for name, a, b in tr["device"]:
        per_op[name[:120]] += (b - a) / 1e9
    host = sorted(tr["host"], key=lambda h: h[1])
    named = []
    for a, b in sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]:
        mid = (a + b) // 2
        inner = [h for h in host if h[1] <= mid <= h[2]]
        label = (min(inner, key=lambda h: h[2] - h[1])[0][:120] if inner
                 else "host")
        named.append([label, (b - a) / 1e9])
    return {"device_ops": [[k, v] for k, v in per_op.most_common(10)],
            "idle_gaps": named}


def kernel_time(ctx: dict, name: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels named `<name>_kernel` in
    the profiled stretch."""
    tr = ctx.get("trace")
    if tr is None:
        return 0, 0.0
    hits = [(a, b) for n, a, b in tr["device"]
            if f"{name}_kernel" in n]
    return len(hits), sum(b - a for a, b in hits) / 1e9
