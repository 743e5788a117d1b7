"""Host-side structured traces: lightweight spans -> Chrome trace JSON.

The fleet pipeline's wall time hides in phases the step outputs can't
see — provider build, the warm-up step (kernel build and load), the
steady-state episode. `Tracer` records named spans (a
`with span("fleet/compile")` context) with microsecond timestamps and
exports the Chrome trace event format, so a whole run opens directly in
`chrome://tracing` / Perfetto.

Design constraints:

  * zero overhead when no tracer is active: the module-level `span()`
    returns a shared nullcontext, so instrumented library code
    (prepare_fleet_run, run_fleet) costs nothing in normal runs;
  * spans measure *host* time: a span around work on the card covers it
    only where that work ends in a synchronize (run_fleet's do);
  * optional `nvtx=True` additionally opens a `torch.cuda.nvtx.range`
    per span so spans line up with device timelines a CUDA profiler
    captures.

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

_NULL = nullcontext()


class Tracer:
    """Span recorder exporting the Chrome trace event format."""

    def __init__(self, *, nvtx: bool = False):
        self.events: list[dict] = []
        self.nvtx = nvtx
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str, **args):
        """Record one complete ("ph": "X") span around the with-body.
        Extra kwargs land in the event's `args` (must be JSON-native)."""
        if self.nvtx:
            import torch

            torch.cuda.nvtx.range_push(name)
        start = time.perf_counter()
        try:
            yield self
        finally:
            dur = time.perf_counter() - start
            if self.nvtx:
                torch.cuda.nvtx.range_pop()
            ev = {"name": name, "ph": "X", "pid": os.getpid(),
                  "tid": threading.get_ident(),
                  "ts": (start - self._t0) * 1e6, "dur": dur * 1e6}
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


def activate(tracer: Tracer | None = None, **kwargs) -> Tracer:
    """Install `tracer` (or a fresh Tracer(**kwargs)) as the active one."""
    global _active
    _active = tracer if tracer is not None else Tracer(**kwargs)
    return _active


def deactivate() -> Tracer | None:
    """Remove and return the active tracer."""
    global _active
    t, _active = _active, None
    return t


def active_tracer() -> Tracer | None:
    return _active


def span(name: str, **args):
    """Span on the active tracer — a shared no-op context when none is
    active, so instrumentation in hot entry points is free by default."""
    t = _active
    if t is None:
        return _NULL
    return t.span(name, **args)


@contextmanager
def tracing(path: str | None = None, *, nvtx: bool = False):
    """Activate a fresh tracer for the with-body; save Chrome trace JSON
    to `path` on exit (when given) and restore the previous tracer."""
    prev = _active
    t = activate(Tracer(nvtx=nvtx))
    try:
        yield t
    finally:
        globals()["_active"] = prev
        if path is not None:
            t.save(path)
