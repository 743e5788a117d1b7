"""The phase readers on a synthetic profiled stretch: two steps with
known `madeye/*` spans, known kernels and one `cudaStreamSynchronize`
inside a step. Every reader returns the known per-step values, None
without device events, None without `madeye/step` spans (a program that
records none), and the learn readers None without a `madeye/learn`
span."""
from __future__ import annotations

import json

import pytest

from bench.harness.runner import read_metric
from conftest import ROOT

MS = 1_000_000
# per step (starting at 0 and 100 ms): phase spans in ms
PHASE_SPANS = {"scene": (0, 40), "noise": (40, 50), "detect": (50, 80),
               "controller": (80, 95), "learn": (95, 100)}
# kernels in ms, per step: the device is idle 0-10, 30-42, 48-55 and
# 75-110 (into the next step)
KERNELS = [(10, 30), (42, 48), (55, 75)]
# host ms and device idle ms per step
WANT = {"scene": (40, 20), "noise": (10, 4), "detect": (30, 10),
        "controller": (15, 15), "learn": (5, 5)}
PHASE_METRICS = [f"{p}_{k}_ms" for p in WANT for k in ("host", "idle")]
SPAN_METRICS = PHASE_METRICS + ["step_syncs"]


def trace(learn: bool = True, device: bool = True, steps: bool = True):
    host, dev = [], []
    for s in (0, 100):
        if steps:
            host.append(("madeye/step", s * MS, (s + 100) * MS))
        for phase, (a, b) in PHASE_SPANS.items():
            if learn or phase != "learn":
                host.append((f"madeye/{phase}", (s + a) * MS,
                             (s + b) * MS))
        host.append(("cudaLaunchKernel", (s + 11) * MS, (s + 12) * MS))
        dev += [(f"k{i}_kernel", (s + a) * MS, (s + b) * MS)
                for i, (a, b) in enumerate(KERNELS)]
    host.append(("cudaStreamSynchronize", 45 * MS, 46 * MS))
    # the stretch's closing synchronise, outside every step
    host.append(("cudaDeviceSynchronize", 200 * MS, 201 * MS))
    return {"host": host, "device": dev if device else [], "steps": 2}


def read_all(tr) -> dict:
    ctx = {"trace": tr}
    return {m: read_metric(ROOT, m, ctx) for m in SPAN_METRICS}


def test_readers_return_the_known_values():
    got = read_all(trace())
    for phase, (host, idle) in WANT.items():
        assert got[f"{phase}_host_ms"] == pytest.approx(host, abs=1e-9)
        assert got[f"{phase}_idle_ms"] == pytest.approx(idle, abs=1e-9)
    assert got["step_syncs"] == 0.5


def test_learn_readers_silent_without_learn_span():
    got = read_all(trace(learn=False))
    assert got["learn_host_ms"] is None and got["learn_idle_ms"] is None
    assert got["scene_host_ms"] == pytest.approx(40, abs=1e-9)


@pytest.mark.parametrize("kw", [{"device": False}, {"steps": False}],
                         ids=["no_device_events", "no_step_spans"])
def test_readers_silent(kw):
    assert set(read_all(trace(**kw)).values()) == {None}


def test_table_computed_once_per_run(monkeypatch):
    from bench.harness import spans

    calls = []
    real = spans.phase_table
    monkeypatch.setattr(spans, "phase_table",
                        lambda tr: calls.append(1) or real(tr))
    ctx = {"trace": trace()}
    for m in SPAN_METRICS:
        spans.phase_metric(ctx, m)
    assert len(calls) == 1


def test_entries_name_their_cells():
    per_layer = {m["name"]: m for m in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    cells = ["approx-f64-k18", "distill-f64-k18", "approx-f256-k18"]
    for name in SPAN_METRICS:
        m = per_layer[name]
        assert (m["source"], m["moves"], m["better"]) == (
            "device_trace", "camera_steps_per_s", "lower")
        want = (["distill-f64-k18"] if name.startswith("learn_")
                else cells)
        assert m["workloads"] == want
