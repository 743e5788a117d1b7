"""The port's `tables` provider and the host substrate under it against
the JAX package, on the same seeded inputs.

  * the numpy copies (`repro_torch.data`, `repro_torch.serving`, the
    single-camera controller and the baselines): bit-equal to `repro`'s
    on a 4 s video (snapshots, ground truth, teacher detections,
    accuracy, motion and largest-object tables, RunResults);
  * `build_episode_tables`: bit-equal on every leaf;
  * the F=1 lockstep of the port's fleet_step with its numpy
    MadEyeController (the reference's tests/test_fleet_parity.py spec);
  * `run_fleet(provider="tables")` at F = 2 and 4: explored, order,
    n_explored, zooms, sent, k_send and chosen equal to `repro`'s,
    acc_per_step within 1e-6 (float32 means of equal grades); with
    metrics on, integer metrics equal and float ones within 1e-5 (the
    tolerance of tests/test_torch_learn.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.core import DEFAULT_GRID, Query, Workload  # noqa: E402
from repro.core.tradeoff import BudgetConfig  # noqa: E402
from repro.data import SceneConfig, build_video  # noqa: E402
from repro.data.dataset import largest_object_table, motion_table  # noqa: E402
from repro.data.render import render_image  # noqa: E402
from repro.fleet.api import FleetRunSpec as JSpec  # noqa: E402
from repro.fleet.api import run_fleet as j_run_fleet  # noqa: E402
from repro.fleet.runner import build_episode_tables as j_build  # noqa: E402
from repro.serving import NetworkTrace, detection_tables  # noqa: E402
from repro.serving import pipeline as jpipe  # noqa: E402
from repro.serving.accuracy import workload_acc_table  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.core import DEFAULT_GRID as TGRID  # noqa: E402
from repro_torch.core import Query as TQuery  # noqa: E402
from repro_torch.core import Workload as TWorkload  # noqa: E402
from repro_torch.core.madeye import MadEyeController  # noqa: E402
from repro_torch.core.tradeoff import BudgetConfig as TBudget  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    FleetRunSpec,
    build_episode_tables,
    fleet_config,
    fleet_statics,
    init_fleet,
    make_tables_provider,
    run_fleet,
    workload_spec,
)
from repro_torch.fleet.step import fleet_step  # noqa: E402
from repro_torch.serving import pipeline as tpipe  # noqa: E402

QUERIES = (("yolov4", "person", "count"), ("ssd", "car", "detect"),
           ("frcnn", "person", "binary"), ("tiny-yolov4", "person",
                                           "agg_count"))
WORKLOAD = Workload(tuple(Query(*q) for q in QUERIES))
TWORKLOAD = TWorkload(tuple(TQuery(*q) for q in QUERIES))
FPS = 2.0
MISS = 0.12
DECISIONS = ("explored", "order", "n_explored", "zooms", "sent", "k_send",
             "chosen")
SCHEMES = ("one_time_fixed", "best_fixed", "best_dynamic", "panoptes",
           "tracking", "ucb1")


@pytest.fixture(scope="module")
def substrate():
    """The same 4 s seed-3 substrate through both packages."""
    video = build_video(DEFAULT_GRID, SceneConfig(fps=15, seed=3), 4.0)
    tables = detection_tables(video, WORKLOAD)
    jax_side = (video, tables, workload_acc_table(video, WORKLOAD, tables),
                NetworkTrace.fixed(24.0, 20.0, video.n_frames))
    video = tdata.build_video(TGRID, tdata.SceneConfig(fps=15, seed=3), 4.0)
    tables = tserving.detection_tables(video, TWORKLOAD)
    torch_side = (video, tables,
                  tserving.workload_acc_table(video, TWORKLOAD, tables),
                  tserving.NetworkTrace.fixed(24.0, 20.0, video.n_frames))
    return {"jax": jax_side, "torch": torch_side}


# ---------------------------------------------------------------------------
# the numpy copies
# ---------------------------------------------------------------------------

def _equal_dicts(a: dict, b: dict, where: str):
    assert sorted(a) == sorted(b), where
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=f"{where} {k}")


def test_video_is_bit_equal(substrate):
    jv, tv = substrate["jax"][0], substrate["torch"][0]
    assert tv.n_frames == jv.n_frames == 60 and tv.fps == jv.fps
    for t in range(jv.n_frames):
        _equal_dicts(jv.snapshots[t], tv.snapshots[t], f"snapshot {t}")
        for z in jv.gt_zoom:
            for c in range(DEFAULT_GRID.n_cells):
                _equal_dicts(jv.gt_zoom[z][t][c], tv.gt_zoom[z][t][c],
                             f"gt z={z} t={t} c={c}")


def test_detection_and_accuracy_tables_are_bit_equal(substrate):
    jv, jtab, jacc, _ = substrate["jax"]
    tv, ttab, tacc, _ = substrate["torch"]
    assert sorted(ttab) == sorted(jtab)
    for key in jtab:
        for z, per_t in jtab[key].dets.items():
            for t, row in enumerate(per_t):
                for c, det in enumerate(row):
                    _equal_dicts(det, ttab[key].dets[z][t][c],
                                 f"{key} z={z} t={t} c={c}")
    np.testing.assert_array_equal(tacc, jacc)
    np.testing.assert_array_equal(tdata.motion_table(tv), motion_table(jv))
    for a, b in zip(tdata.largest_object_table(tv),
                    largest_object_table(jv)):
        np.testing.assert_array_equal(a, b)
    snap_j, snap_t = jv.snapshots[7], tv.snapshots[7]
    np.testing.assert_array_equal(
        tdata.render_image(snap_t, TGRID, 12, 2.0, res=32),
        render_image(snap_j, DEFAULT_GRID, 12, 2.0, res=32))


def test_mobile_trace_is_bit_equal():
    np.testing.assert_array_equal(
        tserving.NetworkTrace.mobile(50, seed=4).mbps,
        NetworkTrace.mobile(50, seed=4).mbps)


def test_run_madeye_is_equal(substrate):
    jv, jtab, jacc, jtr = substrate["jax"]
    tv, ttab, tacc, ttr = substrate["torch"]
    want = jpipe.run_madeye(jv, WORKLOAD, jtab, BudgetConfig(fps=FPS), jtr,
                            acc_table=jacc)
    got = tpipe.run_madeye(tv, TWORKLOAD, ttab, TBudget(fps=FPS), ttr,
                           acc_table=tacc)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    want = jpipe.run_madeye_topk(jv, WORKLOAD, jtab, BudgetConfig(fps=FPS),
                                 jtr, 2, acc_table=jacc)
    got = tpipe.run_madeye_topk(tv, TWORKLOAD, ttab, TBudget(fps=FPS), ttr,
                                2, acc_table=tacc)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_baseline_schemes_are_equal(substrate, scheme):
    jv, jtab, jacc, _ = substrate["jax"]
    tv, ttab, tacc, _ = substrate["torch"]
    want = jpipe.run_scheme(jv, WORKLOAD, jtab, scheme,
                            budget=BudgetConfig(fps=FPS), acc_table=jacc)
    got = tpipe.run_scheme(tv, TWORKLOAD, ttab, scheme,
                           budget=TBudget(fps=FPS), acc_table=tacc)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ---------------------------------------------------------------------------
# the tables provider
# ---------------------------------------------------------------------------

def test_build_episode_tables_is_bit_equal(substrate):
    jv, jtab, jacc, jtr = substrate["jax"]
    tv, ttab, tacc, ttr = substrate["torch"]
    want = j_build(jv, WORKLOAD, jtab, BudgetConfig(fps=FPS), jtr,
                   approx_miss=MISS, acc_table=jacc)
    got = build_episode_tables(tv, TWORKLOAD, ttab, TBudget(fps=FPS), ttr,
                               approx_miss=MISS, acc_table=tacc,
                               device="cpu")
    assert got._fields == want._fields
    for name, g, w in zip(want._fields, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_observe_hands_the_step_expanded_views(substrate):
    """The fleet-shared [N, Z, ...] row reaches fleet_step as [F, N, Z,
    ...] views with stride 0 on the fleet axis: no copy per camera."""
    tv, ttab, tacc, ttr = substrate["torch"]
    ep = build_episode_tables(tv, TWORKLOAD, ttab, TBudget(fps=FPS), ttr,
                              acc_table=tacc, device="cpu")
    st = init_fleet(TGRID, 3, device="cpu")
    xs = tuple(x[2] for x in ep.scan_xs())
    _, obs = ep.observe(None, None, (), st, xs)
    for name in ("counts", "areas", "centroid", "spread", "extent", "nbox",
                 "acc_true"):
        v, row = getattr(obs, name), getattr(ep, name)[2]
        assert v.shape == (3,) + row.shape and v.stride(0) == 0, name
        assert v.data_ptr() == row.data_ptr(), name
    assert obs.mbps.shape == () and obs.rtt.shape == ()


def test_f1_lockstep_with_numpy_controller(substrate):
    """The port's fleet_step at F=1 on the tables decides as the port's
    numpy MadEyeController on every step: path order, sent set, zooms."""
    tv, ttab, tacc, ttr = substrate["torch"]
    budget = TBudget(fps=FPS)
    ep = build_episode_tables(tv, TWORKLOAD, ttab, budget, ttr,
                              approx_miss=MISS, acc_table=tacc,
                              device="cpu")
    ctrl = MadEyeController(TGRID, TWORKLOAD, budget=budget)
    stride = max(1, int(round(tv.fps / budget.fps)))
    frames = list(range(0, tv.n_frames, stride))
    cfg = fleet_config(TGRID, budget)
    spec = workload_spec(TWORKLOAD)
    statics = fleet_statics(TGRID)
    st = init_fleet(TGRID, 1)
    sizes = []
    for ei, t in enumerate(frames):
        ctrl.report_network(ttr.observed_mbps(t), ttr.rtt_s)

        def observe(cells, zooms, _t=t):
            return [tpipe._observation_from_tables(
                ttab, TWORKLOAD, TGRID, _t, c, int(zi), MISS)
                for c, zi in zip(cells, zooms)]

        res = ctrl.step(observe)
        zoom_of = {c: int(z) for c, z in zip(res.explored, res.zooms)}
        if len(res.explored) > 1:
            # run_madeye's rank-agreement feedback, quantized to f32 (the
            # ranking precision both controllers share)
            true_vals = np.asarray(
                [tacc[t, c, zoom_of[c]] for c in res.explored], np.float32)
            pred32 = np.asarray(res.pred_acc, np.float32)
            agree = float(res.explored[int(np.argmax(pred32))]
                          == res.explored[int(np.argmax(true_vals))])
            ctrl.report_train_acc(0.9 * ctrl.train_acc + 0.1 * agree)

        _, obs = ep.observe(cfg, spec, (), st, tuple(x[ei] for x in ep))
        st, out = fleet_step(cfg, spec, statics, st, obs)
        order = out.order[0].tolist()[: int(out.n_explored[0])]
        assert order == list(res.explored), f"path order @ step {ei}"
        sent = set(torch.nonzero(out.sent[0]).flatten().tolist())
        assert sent == set(res.sent), f"sent set @ step {ei}"
        zooms = out.zooms[0].tolist()
        assert {c: zooms[c] for c in order} == zoom_of, f"zooms @ step {ei}"
        sizes.append(len(order))
    assert max(sizes) > 1


@pytest.fixture(scope="module")
def fleet_runs():
    """run_fleet(provider="tables") in both packages from one spec JSON:
    F=2 plain, F=4 with metrics on."""
    runs = {}
    for f, metrics in ((2, None), (4, True)):
        s = JSpec(provider="tables", n_cameras=f, n_steps=6, seed=3,
                  budget={"fps": FPS}, metrics=metrics).to_json()
        runs[f] = (j_run_fleet(JSpec.from_json(s)),
                   run_fleet(FleetRunSpec.from_json(s), device="cpu"))
    return runs


@pytest.mark.parametrize("f", [2, 4])
def test_tables_episode_decides_as_jax(fleet_runs, f):
    want, got = fleet_runs[f]
    assert got.n_steps == want.n_steps == 6 and got.n_cameras == f
    for name in DECISIONS:
        np.testing.assert_array_equal(
            getattr(got.out, name).numpy(),
            np.asarray(getattr(want.out, name)), err_msg=name)
    assert got.chosen == want.chosen
    assert got.frames_sent == want.frames_sent
    np.testing.assert_allclose(got.acc_per_step, want.acc_per_step,
                               atol=1e-6, rtol=0)


def test_tables_lanes_are_identical(fleet_runs):
    """One shared world: every camera of the fleet decides alike."""
    _, got = fleet_runs[4]
    for name in DECISIONS:
        x = getattr(got.out, name)
        assert torch.equal(x, x[:, :1].expand_as(x)), name


def test_tables_episode_metrics_match_jax(fleet_runs):
    want, got = fleet_runs[4]
    assert sorted(got.metrics) == sorted(want.metrics)
    for k, v in want.metrics.items():
        a, b = np.asarray(v), got.metrics[k].numpy()
        assert b.shape == a.shape == (6, 4), k
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5,
                                       err_msg=k)


def test_from_objects_rides_the_prebuilt_substrate(substrate, fleet_runs):
    """FleetRunSpec.from_objects carries in-memory video/tables/trace/
    acc_table through provider_kwargs, as serve does; the decisions equal
    the reference's from_objects run on its own substrate."""
    from repro.fleet.api import FleetRunSpec as J

    jv, jtab, jacc, jtr = substrate["jax"]
    tv, ttab, tacc, ttr = substrate["torch"]
    want = j_run_fleet(J.from_objects(
        "tables", n_cameras=2, grid=DEFAULT_GRID, workload=WORKLOAD,
        budget=BudgetConfig(fps=FPS), video=jv, tables=jtab, trace=jtr,
        acc_table=jacc))
    spec = FleetRunSpec.from_objects(
        "tables", n_cameras=2, grid=TGRID, workload=TWORKLOAD,
        budget=TBudget(fps=FPS), video=tv, tables=ttab, trace=ttr,
        acc_table=tacc)
    assert spec.provider_kwargs["video"] is tv
    got = run_fleet(spec, device="cpu")
    assert got.n_steps == want.n_steps == 8
    for name in DECISIONS:
        np.testing.assert_array_equal(
            getattr(got.out, name).numpy(),
            np.asarray(getattr(want.out, name)), err_msg=name)


def test_tables_provider_never_falls_back_to_cpu():
    """Without a card, make_tables_provider not told device='cpu'
    raises before building anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = fleet_config(TGRID)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_tables_provider(TGRID, TWORKLOAD, cfg, n_cameras=1,
                             n_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fleet(FleetRunSpec(provider="tables", n_cameras=1, n_steps=1))
