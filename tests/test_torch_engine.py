"""The port's serving engine (`repro_torch.serving.engine`) against the
JAX package's (`repro.serving.engine`) on the same seeded inputs, as
tests/test_fleet_engine.py drives the reference; its three controller
shims against the port's own `run_fleet`, as tests/test_fleet_parity.py
holds the reference's.

Tolerances: top-k cells exact on the same labels (ties, and k_send past
a camera's explored cells, go to the lower index in both); visit counts
exact; the EWMA averages, labels and predicted accuracy (which
fleet_step also keeps as the last values) within 1e-6: XLA fuses their
multiply-adds, alpha * x + (1 - alpha) * avg and 0.7 * c + 0.3 * a,
into FMAs; detections within 1e-4 after the whole forward
(tests/test_torch_detector.py), counts exact away from the threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import detector as jdet  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.core import DEFAULT_GRID, Query, Workload  # noqa: E402
from repro_torch.core.ewma import EWMAState  # noqa: E402
from repro_torch.core.tradeoff import BudgetConfig  # noqa: E402
from repro_torch.data import SceneConfig, build_video  # noqa: E402
from repro_torch.fleet import FleetRunSpec, run_fleet  # noqa: E402
from repro_torch.models import detector as tdet  # noqa: E402
from repro_torch.serving import NetworkTrace, detection_tables  # noqa: E402
from repro_torch.serving import engine as teng  # noqa: E402
from repro_torch.serving.accuracy import workload_acc_table  # noqa: E402
from repro_torch.train.optim import tree_leaves  # noqa: E402

CFG = get_smoke_config("madeye-approx")
DECISIONS = ("explored", "order", "n_explored", "zooms", "sent", "k_send",
             "chosen")
WORKLOAD = Workload((Query("yolov4", "person", "count"),
                     Query("ssd", "car", "detect")))
BUDGET = BudgetConfig(fps=2.0)


def _assert_state_equal(got, want, atol=0.0, exact=("seen",)):
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=0.0 if name in exact else atol,
                                   err_msg=name)


def _ranking_inputs(c, n, seed, ties=False):
    rng = np.random.default_rng(seed)
    visited = rng.random((c, n)) < 0.3
    visited[0] = False                      # a camera that explored nothing
    visited[1, :2] = True                   # one that explored 2 cells
    visited[1, 2:] = False
    counts = rng.poisson(2.0, (c, n)).astype(np.float32)
    if ties:
        counts = np.minimum(counts, 1.0)    # many equal counts
    counts *= visited
    areas = (counts * 0.01 if ties else counts * rng.uniform(
        0.005, 0.02, (c, n))).astype(np.float32)
    return visited, counts, areas


def test_init_fleet_state_shapes():
    st = teng.init_fleet_state(64, 25, device="cpu")
    assert isinstance(st, EWMAState)
    assert st.acc.shape == (64, 25) and not st.seen.any()
    want = jeng.init_fleet_state(64, 25)
    _assert_state_equal(st, want)


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.init_fleet_state(2, 25)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.InferenceEngine(CFG, tdet.detector_init(
            torch.Generator().manual_seed(0), CFG))


@pytest.mark.parametrize("seed", [0, 1])
def test_fleet_update_labels_and_topk_match_jax(seed):
    c, n = 8, 25
    st, jst = teng.init_fleet_state(c, n, device="cpu"), \
        jeng.init_fleet_state(c, n)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        visited = rng.random((c, n)) < 0.4
        vals = rng.random((c, n)).astype(np.float32)
        st = teng.fleet_update_labels(st, torch.as_tensor(visited),
                                      torch.as_tensor(vals))
        jst = jeng.fleet_update_labels(jst, jnp.asarray(visited),
                                       jnp.asarray(vals))
        _assert_state_equal(st, jst, atol=1e-6, exact=("seen", "last"))
    lab = teng.fleet_labels(st)
    jlab = jeng.fleet_labels(jst)
    np.testing.assert_allclose(lab.numpy(), np.asarray(jlab), atol=1e-6,
                               rtol=0)
    # the ranking of the same labels (unvisited cells tie at eps)
    lab = torch.as_tensor(np.asarray(jlab))
    for k in (1, 4, n):
        vals_k, cells_k = teng.fleet_topk_cells(lab, k)
        jv, jc = jeng.fleet_topk_cells(jlab, k)
        np.testing.assert_array_equal(cells_k.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(vals_k.numpy(), np.asarray(jv))


def test_fleet_update_is_per_camera():
    c, n = 8, 25
    st = teng.init_fleet_state(c, n, device="cpu")
    visited = torch.zeros((c, n), dtype=torch.bool)
    visited[3, 7] = True
    vals = torch.zeros((c, n))
    vals[3, 7] = 0.9
    st = teng.fleet_update_labels(st, visited, vals)
    assert float(st.acc[3, 7]) == np.float32(0.9)
    assert float(st.acc[2, 7]) == 0.0
    _, cells = teng.fleet_topk_cells(teng.fleet_labels(st), 4)
    assert cells.shape == (c, 4) and int(cells[3, 0]) == 7
    # camera 2 saw nothing: its labels tie, so its picks are cells 0..3
    assert cells[2].tolist() == [0, 1, 2, 3]


def test_fleet_topk_ties_match_jax():
    """Ties (and -inf rows) go to the lower cell, as lax.top_k's."""
    lab = np.array([[0.5, 0.5, 0.2, 0.5, 0.2],
                    [-np.inf] * 5,
                    [0.1, -np.inf, 0.1, -np.inf, 0.3]], np.float32)
    for k in (1, 2, 3, 5):
        _, got = teng.fleet_topk_cells(torch.as_tensor(lab), k)
        _, want = jeng.fleet_topk_cells(jnp.asarray(lab), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k_send", [2, 5])
def test_fleet_step_matches_jax(ties, k_send):
    """Random explored sets (one camera explored nothing, one 2 cells,
    so k_send = 5 passes their explored counts: the remaining picks are
    their lowest unexplored cells), with and without tied counts."""
    c, n = 16, 25
    visited, counts, areas = _ranking_inputs(c, n, 3 + ties, ties)
    st = teng.init_fleet_state(c, n, device="cpu")
    jst = jeng.init_fleet_state(c, n)
    for step in range(2):
        st, cells, pred = teng.fleet_step(
            st, torch.as_tensor(counts), torch.as_tensor(areas),
            torch.as_tensor(visited), k_send=k_send)
        jst, jcells, jpred = jeng.fleet_step(
            jst, jnp.asarray(counts), jnp.asarray(areas),
            jnp.asarray(visited), k_send=k_send)
        np.testing.assert_array_equal(cells.numpy(), np.asarray(jcells))
        np.testing.assert_allclose(pred.numpy(), np.asarray(jpred),
                                   atol=1e-6, rtol=0)
        _assert_state_equal(st, jst, atol=1e-6)
    assert cells[0].tolist() == list(range(k_send))
    assert sorted(cells[1, :2].tolist()) == [0, 1]
    if k_send == 5:
        assert cells[1, 2:].tolist() == [2, 3, 4]


def test_fleet_step_scales_to_1k_cameras():
    c, n = 1000, 25
    st = teng.init_fleet_state(c, n, device="cpu")
    visited = torch.ones((c, n), dtype=torch.bool)
    counts = torch.rand((c, n), generator=torch.Generator().manual_seed(0))
    st2, cells, _ = teng.fleet_step(st, counts, counts * 0.01, visited)
    assert cells.shape == (c, 2) and bool((st2.seen == 1).all())


@pytest.fixture(scope="module")
def weights():
    jp = jdet.detector_init(jax.random.PRNGKey(5), CFG)
    return jp, jax.tree.map(np.asarray, jp)


def test_engine_scoring_matches_jax(weights):
    jp, np_params = weights
    rng = np.random.default_rng(1)
    imgs = rng.uniform(0, 1, (6, CFG.img_res, CFG.img_res, 3)).astype(
        np.float32)
    engine = teng.InferenceEngine(CFG, np_params, device="cpu")
    jengine = jeng.InferenceEngine(CFG, jp)
    d, jd = engine.score_batch(imgs), jengine.score_batch(jnp.asarray(imgs))
    assert d.boxes.shape == (6, CFG.max_boxes, 4)
    for name in ("scores", "boxes", "class_probs"):
        np.testing.assert_allclose(getattr(d, name).numpy(),
                                   np.asarray(getattr(jd, name)),
                                   atol=1e-4, rtol=0, err_msg=name)
    scores = d.scores.numpy()
    for thresh in (0.0, 0.3):
        counts, areas = engine.counts_and_areas(imgs, score_thresh=thresh)
        jc, ja = jengine.counts_and_areas(jnp.asarray(imgs),
                                          score_thresh=thresh)
        near = (np.abs(scores - thresh) < 1e-4).any(-1)
        np.testing.assert_array_equal(counts.numpy()[~near],
                                      np.asarray(jc)[~near])
        np.testing.assert_allclose(areas.numpy()[~near],
                                   np.asarray(ja)[~near], atol=1e-4)
    counts, _ = engine.counts_and_areas(imgs, score_thresh=0.0)
    assert bool((counts == CFG.max_boxes).all())    # thresh 0 keeps all

    # the module-level functions are the engine's
    tp = engine.params
    x = torch.as_tensor(imgs)
    assert torch.equal(teng.detector_scores(tp, CFG, x).scores, d.scores)
    tok = tdet.vit.vit_embed(tp["backbone"]["vit"], x, patch=CFG.patch)
    jtok = jdet.vit.vit_embed(jp["backbone"]["vit"],
                              jdet._backbone_cfg(CFG), jnp.asarray(imgs))
    dt = teng.detector_scores_tokens(tp, CFG, tok)
    jdt = jeng.detector_scores_tokens(jp, CFG, jtok)
    np.testing.assert_allclose(dt.scores.numpy(), np.asarray(jdt.scores),
                               atol=1e-4, rtol=0)
    c2, a2 = teng.detector_counts_and_areas(tp, CFG, x, 0.3)
    c3, a3 = engine.counts_and_areas(imgs, score_thresh=0.3)
    assert torch.equal(c2, c3) and torch.equal(a2, a3)


# ---------------------------------------------------------------------------
# the controller shims against run_fleet (the port's own)
# ---------------------------------------------------------------------------

def _assert_same_decisions(a, b):
    for name in DECISIONS:
        assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_tables_controller_matches_run_fleet():
    video = build_video(DEFAULT_GRID, SceneConfig(fps=15, seed=3), 3.0)
    tables = detection_tables(video, WORKLOAD)
    acc = workload_acc_table(video, WORKLOAD, tables)
    trace = NetworkTrace.fixed(24.0, 20.0, video.n_frames)
    st, out = teng.run_fleet_controller(
        video, WORKLOAD, tables, BUDGET, trace, n_cameras=2,
        acc_table=acc, device="cpu")
    res = run_fleet(FleetRunSpec.from_objects(
        "tables", n_cameras=2, grid=DEFAULT_GRID, workload=WORKLOAD,
        budget=BUDGET, video=video, tables=tables, trace=trace,
        acc_table=acc), device="cpu")
    _assert_same_decisions(out, res.out)
    assert torch.equal(st.step_idx, res.state.step_idx)


def test_scene_controller_matches_run_fleet():
    kw = dict(n_cameras=2, n_steps=6, seed=11, scene_seeds=[4, 7])
    _, out = teng.run_fleet_scene_controller(DEFAULT_GRID, WORKLOAD, BUDGET,
                                             device="cpu", **kw)
    res = run_fleet(FleetRunSpec.from_objects(
        "scene", grid=DEFAULT_GRID, workload=WORKLOAD, budget=BUDGET, **kw),
        device="cpu")
    _assert_same_decisions(out, res.out)
    assert res.accuracy == pytest.approx(float(out.acc_chosen.mean()))


@pytest.mark.parametrize("distill", [None, True])
def test_detector_controller_matches_run_fleet(distill):
    """Frozen: (state, out); with distill the learning tail (extras,
    final carry) as well, and the same decisions and losses."""
    kw = dict(n_cameras=2, n_steps=3, seed=0, scene_seeds=[5, 9],
              shortlist_k=9)
    ret = teng.run_fleet_detector_controller(
        DEFAULT_GRID, WORKLOAD, BUDGET, distill=distill, device="cpu", **kw)
    spec = FleetRunSpec.from_objects(
        "detector", grid=DEFAULT_GRID, workload=WORKLOAD, budget=BUDGET,
        distill=distill, det_seed=0, **kw)
    res = run_fleet(spec, device="cpu")
    if distill is None:
        assert len(ret) == 2
    else:
        assert len(ret) == 4
        loss = ret[2]["learn"]["loss"].numpy().astype(np.float32)
        upd = loss >= 0.0
        nupd = upd.sum(axis=1)
        mean = np.where(nupd > 0, (loss * upd).sum(axis=1)
                        / np.maximum(nupd, 1), -1.0)
        np.testing.assert_array_equal(mean, np.asarray(res.distill_loss,
                                                       np.float32))
        provider = res.learned[0]
        for a, b in zip(tree_leaves(provider.learned_params(ret[3], 0)),
                        tree_leaves(res.learned_params(0))):
            assert torch.equal(a, b)
    _assert_same_decisions(ret[1], res.out)


def test_controller_refuses_mesh():
    """mesh= reaches the episode (sharded runs: tests/test_torch_fleet_
    shard.py); what is not a mesh is refused."""
    with pytest.raises(TypeError, match="mesh"):
        teng.run_fleet_scene_controller(DEFAULT_GRID, WORKLOAD, BUDGET,
                                        n_cameras=1, n_steps=1,
                                        mesh=object(), device="cpu")


def test_unfused_through_detector_controller():
    """provider kwargs reach make_detector_provider: fused=False through
    the shim decides as the fused exhaustive run."""
    kw = dict(n_cameras=1, n_steps=2, seed=0, scene_seeds=[5])
    _, ref = teng.run_fleet_detector_controller(
        DEFAULT_GRID, WORKLOAD, BUDGET, fused=False, device="cpu", **kw)
    _, fast = teng.run_fleet_detector_controller(
        DEFAULT_GRID, WORKLOAD, BUDGET, device="cpu", **kw)
    _assert_same_decisions(ref, fast)
