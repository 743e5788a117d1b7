"""The detector backbone's `madeye/backbone` spans (inside
`madeye/detect`, repro_torch.models.detector) in the profiled stretch,
on the clock of the device's kernels: their host time and the device's
idle time inside them, per `madeye/step` span.

The table is computed once per run and kept in ctx. It is None where
the stretch shows no device activity, no `madeye/step` span, or no
`madeye/backbone` span inside one (a program without the span).
"""
from __future__ import annotations

from bisect import bisect_right

from bench.harness.spans import STEP, _covered_ns
from bench.harness.trace import busy_idle

SPAN = "madeye/backbone"


def backbone_table(tr: dict | None) -> dict | None:
    """{backbone_host_ms, backbone_idle_ms} per whole step of the
    stretch `tr` (as `profile_steps` records it), or None."""
    if not tr or not tr["device"]:
        return None
    steps = sorted((a, b) for name, a, b in tr["host"] if name == STEP)
    starts = [a for a, _ in steps]

    def in_step(t: int) -> bool:
        i = bisect_right(starts, t) - 1
        return i >= 0 and t < steps[i][1]

    spans = [(a, b) for name, a, b in tr["host"]
             if name == SPAN and in_step(a)]
    if not spans:
        return None
    _, _, gaps = busy_idle(tr)
    gap_starts = [a for a, _ in gaps]
    n = len(steps)
    return {"backbone_host_ms": sum(b - a for a, b in spans) / n / 1e6,
            "backbone_idle_ms": sum(_covered_ns(a, b, gaps, gap_starts)
                                    for a, b in spans) / n / 1e6}


def backbone_metric(ctx: dict, name: str) -> float | None:
    """The entry `name` of the run's backbone table (None: nothing to
    read)."""
    if "backbone_table" not in ctx:
        ctx["backbone_table"] = backbone_table(ctx.get("trace"))
    table = ctx["backbone_table"]
    return None if table is None else table[name]
