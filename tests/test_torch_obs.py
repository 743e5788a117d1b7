"""The port's host traces (`repro_torch.obs.trace`) and JSONL telemetry
(`repro_torch.obs.events`), after the reference's tests/test_obs.py, and
the port's event stream against `repro`'s on the same run. The spans
inside a controller step are also held as torch.profiler ranges: in
order, covering the step, on the tracer's clock, and changing no
decision.

Events are compared key for key: ints, strings and lists of them exactly,
floats within 1e-6 (float32 means and EWMA labels of equal decisions),
except the host timings and `camera_steps_per_s`.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.core import DEFAULT_GRID, Query, Workload  # noqa: E402
from repro.core.tradeoff import BudgetConfig  # noqa: E402
from repro.data import SceneConfig, build_video  # noqa: E402
from repro.fleet.api import FleetRunSpec as JSpec  # noqa: E402
from repro.fleet.api import run_fleet as j_run_fleet  # noqa: E402
from repro.obs import episode_events as j_episode_events  # noqa: E402
from repro.serving import NetworkTrace, detection_tables  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.core import DEFAULT_GRID as TGRID  # noqa: E402
from repro_torch.core import Query as TQuery  # noqa: E402
from repro_torch.core import Workload as TWorkload  # noqa: E402
from repro_torch.core.tradeoff import BudgetConfig as TBudget  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    FleetResult,
    FleetRunSpec,
    run_fleet,
)
from repro_torch.distributed.sharding import tree_leaves  # noqa: E402
from repro_torch.fleet.api import prepare_fleet_run  # noqa: E402
from repro_torch.fleet.runner import episode_step  # noqa: E402
from repro_torch.learn.spec import DistillSpec  # noqa: E402
from repro_torch.models.layers import full_float32  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    SCHEMA_VERSION,
    Tracer,
    active_tracer,
    episode_events,
    read_events,
    span,
    summarize_metrics,
    tracing,
    validate_event,
    write_events,
)

QUERIES = (("yolov4", "person", "count"), ("ssd", "car", "detect"),
           ("frcnn", "person", "binary"), ("tiny-yolov4", "person",
                                           "agg_count"))
UNTIMED = ("timings", "camera_steps_per_s")


def _run(provider, metrics=None, **kw):
    spec = FleetRunSpec(provider=provider, n_cameras=2, n_steps=5,
                        budget={"fps": 2.0}, metrics=metrics, **kw)
    return run_fleet(spec, device="cpu")


# ---------------------------------------------------------------------------
# trace spans
# ---------------------------------------------------------------------------

def test_span_is_noop_without_tracer():
    assert active_tracer() is None
    with span("anything", x=1):
        pass                              # shared nullcontext, no error
    assert active_tracer() is None


def test_tracing_records_chrome_events(tmp_path):
    path = str(tmp_path / "trace.json")
    with tracing(path) as tr:
        with span("outer", provider="scene"):
            with span("inner"):
                pass
    assert active_tracer() is None        # restored on exit
    doc = json.load(open(path))
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert [e["name"] for e in evs] == ["inner", "outer"]
    for e in evs:
        assert e["ph"] == "X" and e["dur"] >= 0 and "ts" in e
    assert evs[1]["args"] == {"provider": "scene"}
    assert "args" not in evs[0]
    assert tr.to_chrome()["traceEvents"] == evs


@pytest.mark.parametrize("provider", ["tables", "scene"])
def test_run_fleet_emits_fleet_spans(tmp_path, provider):
    path = str(tmp_path / "trace.json")
    with tracing(path):
        _run(provider, metrics=True)
    evs = {e["name"]: e for e in json.load(open(path))["traceEvents"]}
    assert {"fleet/build", "fleet/compile", "fleet/steady"} <= set(evs)
    assert evs["fleet/build"]["args"] == {"provider": provider,
                                          "n_cameras": 2}
    assert evs["fleet/compile"]["args"] == {"provider": provider,
                                            "metrics": True}
    assert evs["fleet/steady"]["args"] == {"provider": provider,
                                           "n_cameras": 2}


def test_tracer_non_json_args_stringified():
    tr = Tracer()
    with tr.span("s", arr=np.arange(3), t=torch.ones(2)):
        pass
    args = tr.events[0]["args"]
    assert isinstance(args["arr"], str) and isinstance(args["t"], str)


def test_span_without_recorder_is_the_shared_null_context():
    assert active_tracer() is None
    assert not torch.autograd._profiler_enabled()
    assert span("a") is span("b", x=1)


PHASES = ("madeye/scene", "madeye/noise", "madeye/detect",
          "madeye/controller")


def _detector_prep(distill, n_steps=2):
    spec = FleetRunSpec(provider="detector", n_cameras=2, n_steps=n_steps,
                        seed=3, shortlist_k=6, budget={"fps": 3.0},
                        distill=distill)
    return prepare_fleet_run(spec, device="cpu")


def _host_events(prof) -> list:
    """(name, start_ns, end_ns) of the profiler's host events."""
    return [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == torch.autograd.DeviceType.CPU]


@pytest.mark.parametrize("distill", [None, DistillSpec()],
                         ids=["frozen", "distill"])
def test_step_phases_are_profiler_ranges(distill):
    """Two detector steps under a CPU profiler: each `madeye/step` range
    holds the phases in order, and they cover it; the backbone's
    `madeye/backbone` range nests inside the detect phase."""
    from torch.profiler import ProfilerActivity, profile

    prep = _detector_prep(distill)
    p = prep.provider
    state, carry = prep.state, p.init_carry(prep.state)
    with torch.no_grad(), full_float32(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        for e in range(2):
            state, carry, _, _ = episode_step(prep.cfg, prep.wl,
                                              prep.statics, state, p,
                                              carry, e)
    host = _host_events(prof)
    steps = sorted((a, b) for n, a, b in host if n == "madeye/step")
    assert len(steps) == 2
    want = PHASES + (("madeye/learn",) if distill else ())
    for a, b in steps:
        inside = sorted((s, n, t) for n, s, t in host
                        if n.startswith("madeye/")
                        and n not in ("madeye/step", "madeye/backbone")
                        and a <= s and t <= b)
        assert tuple(n for _, n, _ in inside) == want
        assert all(inside[i][2] <= inside[i + 1][0]
                   for i in range(len(inside) - 1))     # no overlap
        assert sum(t - s for s, _, t in inside) >= 0.9 * (b - a)
        detect = next((s, t) for s, n, t in inside if n == "madeye/detect")
        backbone = [(s, t) for n, s, t in host
                    if n == "madeye/backbone" and a <= s and t <= b]
        assert len(backbone) == 1
        assert detect[0] <= backbone[0][0] and backbone[0][1] <= detect[1]


def test_spans_leave_the_episode_unchanged():
    """A distilling detector episode gives bit-identical decisions and
    final state with the spans recorded (a profiler and a tracer) and
    without."""
    from torch.profiler import ProfilerActivity, profile

    def episode(recorded):
        prep = _detector_prep(DistillSpec(), n_steps=3)
        with torch.no_grad(), full_float32():
            if not recorded:
                return prep.episode()
            with profile(activities=[ProfilerActivity.CPU]), \
                    tracing() as tr:
                res = prep.episode()
            assert sum(e["name"] == "madeye/step"
                       for e in tr.events) == 3
            return res

    plain, recorded = episode(False), episode(True)
    for k in ("chosen", "sent"):
        assert torch.equal(getattr(plain[1], k), getattr(recorded[1], k))
    # the final controller state and carry (scene, learned heads, ring)
    want = tree_leaves((plain[0], plain[3]))
    got = tree_leaves((recorded[0], recorded[3]))
    assert len(got) == len(want) > 10
    assert all(torch.equal(x, y) for x, y in zip(got, want)
               if isinstance(x, torch.Tensor))


def test_tracer_and_profiler_share_a_clock():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            tracing() as tr:
        with span("probe"):
            torch.ones(4).sum()
    (ev,) = [e for e in tr.events if e["name"] == "probe"]
    (start_ns,) = [a for n, a, _ in _host_events(prof) if n == "probe"]
    assert abs(ev["ts"] - start_ns / 1e3) < 1e3         # microseconds
    # an operator-scope range: a user annotation would be mirrored onto
    # the device's timeline as an event over the kernels under it
    (fe,) = [e for e in prof.events() if e.name == "probe"]
    assert fe.scope != int(torch._C._profiler.RecordScope.USER_SCOPE)


# ---------------------------------------------------------------------------
# JSONL telemetry events
# ---------------------------------------------------------------------------

def test_validate_event_rejects_malformed():
    with pytest.raises(ValueError, match="unknown event type"):
        validate_event({"event": "nope"})
    with pytest.raises(ValueError, match="missing keys"):
        validate_event({"event": "run_end", "schema": 1})
    with pytest.raises(ValueError, match="cameras.health"):
        validate_event({"event": "steps", "schema": 1, "step0": 0,
                        "step1": 4, "acc_mean": 0.5, "frames_sent": 2,
                        "cameras": {"acc_mean": [], "frames_sent": [],
                                    "n_explored_mean": []}})


def test_episode_events_schema_roundtrip(tmp_path):
    r = _run("scene", metrics=True)
    events = list(episode_events(r, chunk=2))
    assert [e["event"] for e in events] == \
        ["run_start"] + ["steps"] * 3 + ["run_end"]
    start, steps, end = events[0], events[1], events[-1]
    assert start["schema"] == SCHEMA_VERSION
    assert start["spec"]["provider"] == "scene"
    assert start["metrics"] is True
    assert (steps["step0"], steps["step1"]) == (0, 2)
    cams = steps["cameras"]
    assert len(cams["health"]) == r.n_cameras
    assert set(cams["health"]) <= {"ok", "idle", "lagging"}
    assert len(cams["ewma_label"]) == r.n_cameras
    assert end["metrics_summary"]["shortlist_hit_rate"] == \
        [1.0] * r.n_cameras
    assert end["metrics_summary"] == summarize_metrics(r.metrics)
    assert json.dumps(events) is not None  # JSON-native end to end

    path = str(tmp_path / "tel.jsonl")
    assert write_events(iter(events), path) == len(events)
    assert read_events(path) == events
    # append mode: a second run extends the log
    write_events(iter(events), path)
    assert len(read_events(path)) == 2 * len(events)


def test_episode_events_requires_device_outputs():
    r = _run("tables")
    with pytest.raises(ValueError, match="stripped"):
        next(episode_events(FleetResult.from_json(r.to_json())))
    with pytest.raises(ValueError, match="chunk"):
        next(episode_events(r, chunk=0))


def _assert_events_close(got, want, where="events"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            if k not in UNTIMED:
                _assert_events_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_events_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float) and got == pytest.approx(
            want, abs=1e-6, rel=1e-6), where
    else:
        assert type(got) is type(want) and got == want, where


@pytest.fixture(scope="module")
def substrates():
    """A 3 s seed-3 substrate built by each package (for from_objects)."""
    wl = Workload(tuple(Query(*q) for q in QUERIES))
    video = build_video(DEFAULT_GRID, SceneConfig(fps=15, seed=3), 3.0)
    jax_kw = dict(video=video, tables=detection_tables(video, wl),
                  trace=NetworkTrace.fixed(24.0, 20.0, video.n_frames))
    twl = TWorkload(tuple(TQuery(*q) for q in QUERIES))
    video = tdata.build_video(TGRID, tdata.SceneConfig(fps=15, seed=3), 3.0)
    torch_kw = dict(
        video=video, tables=tserving.detection_tables(video, twl),
        trace=tserving.NetworkTrace.fixed(24.0, 20.0, video.n_frames))
    return (wl, jax_kw), (twl, torch_kw)


@pytest.mark.parametrize("how", ["json", "objects"])
def test_episode_events_match_jax(substrates, how):
    """The same tables run through both packages, metrics on: the event
    streams agree (run_start's spec too: a JSON spec as it is, an
    in-memory one with its provider kwargs named, as the reference does)."""
    if how == "json":
        s = JSpec(provider="tables", n_cameras=3, n_steps=5, seed=3,
                  budget={"fps": 2.0}, metrics=True).to_json()
        want = j_run_fleet(JSpec.from_json(s))
        got = run_fleet(FleetRunSpec.from_json(s), device="cpu")
    else:
        (wl, jkw), (twl, tkw) = substrates
        want = j_run_fleet(JSpec.from_objects(
            "tables", n_cameras=3, workload=wl, metrics=True,
            budget=BudgetConfig(fps=2.0), **jkw))
        got = run_fleet(FleetRunSpec.from_objects(
            "tables", n_cameras=3, workload=twl, metrics=True,
            budget=TBudget(fps=2.0), **tkw), device="cpu")
        assert got.n_steps == 6
    w_events = list(j_episode_events(want, chunk=2))
    g_events = list(episode_events(got, chunk=2))
    _assert_events_close(g_events, w_events)
    spec = g_events[0]["spec"]
    if how == "objects":
        assert spec["provider_kwargs"] == {
            "video": "<in-memory Video>", "tables": "<in-memory dict>",
            "trace": "<in-memory NetworkTrace>"}
    assert set(g_events[-1]["timings"]) == {"build_s", "compile_s",
                                            "steady_s", "episode_s"}
