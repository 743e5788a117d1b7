"""Host-side structured traces: lightweight spans -> Chrome trace JSON,
and the same spans in a torch.profiler trace.

The fleet pipeline's wall time hides in phases the step outputs can't
see — provider build, the warm-up step (kernel build and load), the
steady-state episode, and inside each controller step the scene
advance, render noise, detector, controller and learning phases.
`span(name)` marks such a phase. Two recorders read it:

  * a `Tracer` (a `with tracing(path)` block) records named spans with
    microsecond timestamps and exports the Chrome trace event format,
    so a whole run opens directly in `chrome://tracing` / Perfetto;
  * a recording `torch.profiler` gets the span as a host event of its
    own name, on the clock of its kernels, so a span's device activity
    and idle time read off the profiler's trace. The range is recorded
    in the scope of an operator (`_RecordFunctionFast`), not as a user
    annotation (`torch.profiler.record_function`): the profiler mirrors
    a user annotation onto the device's timeline as an event spanning
    the kernels launched under it, which a reader of device activity
    would count as the card being busy.

A `Tracer` stamps `ts` in microseconds since the Unix epoch, the clock
of the profiler's events (`start_ns` of `kineto_results.events()`), so
a tracer's JSON and a profiler trace of the same run line up.

Design constraints:

  * zero overhead when neither records: the module-level `span()`
    returns a shared nullcontext (one check of `_profiler_enabled()`),
    so instrumented library code (prepare_fleet_run, run_fleet,
    episode_step) costs nothing in normal runs;
  * spans measure *host* time: a span around work on the card covers it
    only where that work ends in a synchronize (run_fleet's do); the
    profiler's device events say what the card did meanwhile.

Usage:

    from repro_torch.obs.trace import span, tracing

    with tracing("run_trace.json"):          # activate + save on exit
        with span("build", provider="scene"):
            ...
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext

import torch

_NULL = nullcontext()


class Tracer:
    """Span recorder exporting the Chrome trace event format."""

    def __init__(self):
        self.events: list[dict] = []
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str, **args):
        """Record one complete ("ph": "X") span around the with-body.
        Extra kwargs land in the event's `args` (must be JSON-native)."""
        ts_ns = time.time_ns()
        start = time.perf_counter_ns()
        try:
            yield self
        finally:
            dur_ns = time.perf_counter_ns() - start
            ev = {"name": name, "ph": "X", "pid": os.getpid(),
                  "tid": threading.get_ident(),
                  "ts": ts_ns / 1e3, "dur": dur_ns / 1e3}
            if args:
                ev["args"] = {k: v if isinstance(
                    v, (int, float, str, bool, type(None))) else str(v)
                    for k, v in args.items()}
            with self._lock:
                self.events.append(ev)

    def to_chrome(self) -> dict:
        """The chrome://tracing / Perfetto JSON object."""
        with self._lock:
            return {"traceEvents": list(self.events),
                    "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# ---------------------------------------------------------------------------
# module-level activation (what library code talks to)
# ---------------------------------------------------------------------------

_active: Tracer | None = None


def activate(tracer: Tracer | None = None) -> Tracer:
    """Install `tracer` (or a fresh Tracer) as the active one."""
    global _active
    _active = tracer if tracer is not None else Tracer()
    return _active


def deactivate() -> Tracer | None:
    """Remove and return the active tracer."""
    global _active
    t, _active = _active, None
    return t


def active_tracer() -> Tracer | None:
    return _active


@contextmanager
def _recorded(tracer: Tracer | None, profiled: bool, name: str, args):
    with (_NULL if tracer is None else tracer.span(name, **args)), \
            (torch._C._profiler._RecordFunctionFast(name) if profiled
             else _NULL):
        yield tracer


def span(name: str, **args):
    """Span on the active tracer and, while a torch.profiler records, a
    profiler range of the same name — a shared no-op context when
    neither records, so instrumentation in hot entry points is free by
    default."""
    t = _active
    profiled = torch.autograd._profiler_enabled()
    if t is None and not profiled:
        return _NULL
    return _recorded(t, profiled, name, args)


@contextmanager
def tracing(path: str | None = None):
    """Activate a fresh tracer for the with-body; save Chrome trace JSON
    to `path` on exit (when given) and restore the previous tracer."""
    prev = _active
    t = activate(Tracer())
    try:
        yield t
    finally:
        globals()["_active"] = prev
        if path is not None:
            t.save(path)
