"""The controller step's phases in the profiled stretch, read from the
`madeye/*` spans the program records as profiler ranges while a
torch.profiler records (repro_torch.obs.trace), on the clock of the
device's kernels: each phase's host time, the device's idle time inside
it, and the synchronising CUDA calls inside the step, all per step.

Every phase metric's reader calls `phase_metric`; the table is computed
once per run and kept in ctx. It is None where the stretch shows no
device activity (no device number from a run without one) or no
`madeye/step` span (a program without the spans); a phase without a
span (`madeye/learn` of a frozen run) has no entry.
"""
from __future__ import annotations

from bisect import bisect_right

from bench.harness.trace import busy_idle

STEP = "madeye/step"
PHASES = ("scene", "noise", "detect", "controller", "learn")


def _covered_ns(a: int, b: int, gaps: list, starts: list) -> int:
    """ns of [a, b] inside the sorted, disjoint `gaps` (`starts` their
    starts)."""
    i = max(bisect_right(starts, a) - 1, 0)
    t = 0
    while i < len(gaps) and gaps[i][0] < b:
        t += max(0, min(b, gaps[i][1]) - max(a, gaps[i][0]))
        i += 1
    return t


def phase_table(tr: dict | None) -> dict | None:
    """{<phase>_host_ms, <phase>_idle_ms for each phase with spans,
    step_syncs} per whole `madeye/step` span of the stretch `tr` (as
    `profile_steps` records it), or None."""
    if not tr or not tr["device"]:
        return None
    steps = sorted((a, b) for name, a, b in tr["host"] if name == STEP)
    if not steps:
        return None
    step_starts = [a for a, _ in steps]

    def in_step(t: int) -> bool:
        i = bisect_right(step_starts, t) - 1
        return i >= 0 and t < steps[i][1]

    _, _, gaps = busy_idle(tr)
    gap_starts = [a for a, _ in gaps]
    n = len(steps)
    table = {}
    for phase in PHASES:
        spans = [(a, b) for name, a, b in tr["host"]
                 if name == f"madeye/{phase}" and in_step(a)]
        if spans:
            table[f"{phase}_host_ms"] = sum(b - a for a, b in spans) / n / 1e6
            table[f"{phase}_idle_ms"] = sum(
                _covered_ns(a, b, gaps, gap_starts)
                for a, b in spans) / n / 1e6
    table["step_syncs"] = sum(
        1 for name, a, _ in tr["host"]
        if name.startswith("cuda") and "Synchronize" in name
        and in_step(a)) / n
    return table


def phase_metric(ctx: dict, name: str) -> float | None:
    """The entry `name` of the run's phase table (None: nothing to
    read)."""
    if "phase_table" not in ctx:
        ctx["phase_table"] = phase_table(ctx.get("trace"))
    table = ctx["phase_table"]
    return None if table is None else table.get(name)
