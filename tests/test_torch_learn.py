"""The port's in-episode distillation and metrics against the JAX
package (`repro.learn`, `repro.obs.metrics`) on the same seeded inputs,
with the JAX package's weights carried across by `params_from_numpy`
(and its `.npz` checkpoints).

Tolerances, and why:

- decisions (`chosen`, `explored`, `order`, `zooms`, `sent`), integer
  metrics, pair selections, ring slots, classes and validity: exact;
- teacher boxes 1e-6 (the same float32 ops; XLA may fuse a product
  into a division's neighbour);
- losses 1e-5 relative (float32 sums over cells and samples in another
  order than XLA's);
- parameters after an update 1e-6 absolute (3e-6 in full mode: the
  gradient comes back through the transformer); first moments 1e-6,
  second moments 1e-9 absolute (squares of gradients of order 1e-2).
  AdamW elements whose gradient is at float32 round-off level step by
  up to ~lr either way (the moment ratio of noise), so they are held to
  3 lr per update (`test_distill_update_matches_jax`); over the 8-step
  head-only episode 98% of the learned heads' elements are held to
  2e-6 (every one to 3 lr per update) and float metrics to 1e-5;
- the idle-camera no-op, the frozen run with distill off, and the
  head-only backbone: bit-exact.

Runs at smoke width (`madeye-approx-smoke`), 2 cameras, 8 steps, and at
equal F only (the reference's `test_learning_fleet_size_independent`
fails, so F=1 against F=2 is no reference).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.fleet.api import FleetRunSpec as JSpec  # noqa: E402
from repro.fleet.api import run_fleet as j_run_fleet  # noqa: E402
from repro.fleet.runner import (  # noqa: E402
    load_detector_params as j_load_detector_params,
)
from repro.fleet.runner import save_detector_params  # noqa: E402
from repro.learn import loop as jloop  # noqa: E402
from repro.learn import pairs as jpairs  # noqa: E402
from repro.learn.spec import DistillSpec as JDistill  # noqa: E402
from repro.learn.spec import normalize_distill as j_normalize  # noqa: E402
from repro.models import detector as jdet  # noqa: E402
from repro.scene_jax import observe as jobs  # noqa: E402
from repro.scene_jax import scene as jscene  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.fleet.api import FleetResult  # noqa: E402
from repro_torch.fleet.api import FleetRunSpec as TSpec  # noqa: E402
from repro_torch.fleet.api import prepare_fleet_run  # noqa: E402
from repro_torch.fleet.api import run_fleet as t_run_fleet  # noqa: E402
from repro_torch.fleet.runner import episode_step  # noqa: E402
from repro_torch.fleet.runner import load_detector_params  # noqa: E402
from repro_torch.learn import loop as tloop  # noqa: E402
from repro_torch.learn import pairs as tpairs  # noqa: E402
from repro_torch.learn.spec import DistillSpec  # noqa: E402
from repro_torch.learn.spec import normalize_distill  # noqa: E402
from repro_torch.models import detector as tdet  # noqa: E402
from repro_torch.obs.metrics import MetricsSpec  # noqa: E402
from repro_torch.obs.metrics import median_valid_rank  # noqa: E402
from repro_torch.obs.metrics import summarize_metrics  # noqa: E402
from repro_torch.scene.scene import SceneSpec as TSceneSpec  # noqa: E402
from repro_torch.train import optim as toptim  # noqa: E402
from torch_kernel_inputs import (  # noqa: E402
    ORACLE_WORKLOADS,
    oracle_args,
    oracle_state,
    t,
)

JCFG = get_smoke_config("madeye-approx")
TCFG = t_smoke("madeye-approx")
N_STEPS = 8


def tree_np(tree):
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def assert_tree_close(got, want, atol, rtol=0.0):
    got, want = tree_np(got), tree_np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_tree_close(got[k], want[k], atol, rtol)
        return
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def assert_tree_equal(got, want):
    got, want = tree_np(got), tree_np(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_tree_equal(got[k], want[k])
        return
    np.testing.assert_array_equal(got, want)


def init_np(seed):
    """Seeded smoke-width detector weights as a tree of numpy arrays
    (made by the port: both packages take them as they are, and JAX's
eager initialiser compiles each random draw on its own)."""
    return tree_np(tdet.detector_init(torch.Generator().manual_seed(seed),
                                      TCFG))


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    path = tmp_path_factory.mktemp("det") / "det.npz"
    return save_detector_params(str(path), init_np(1))


def _spec_kw(weights_npz, distill=True, **kw):
    spec = dict(provider="detector", n_cameras=2, n_steps=N_STEPS,
                budget={"fps": 3.0}, seed=3, shortlist_k=9, distill=distill,
                metrics=True,
                provider_kwargs={"scene_seeds": [3, 5],
                                 "det_params": weights_npz, "thresh": 0.3})
    spec.update(kw)
    return spec


@pytest.fixture(scope="module")
def runs(weights_npz):
    """One head-only AdamW learning episode with metrics through both
    packages' run_fleet, from one spec JSON."""
    s = JSpec(**_spec_kw(weights_npz)).to_json()
    return j_run_fleet(JSpec.from_json(s)), t_run_fleet(TSpec.from_json(s),
                                                        device="cpu")


# ---------------------------------------------------------------------------
# DistillSpec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [None, False, True, {"enabled": False},
                               {"lr": 0.01}, {"every": 2, "buffer": 4},
                               {"head_only": False, "optimizer": "sgd"}])
def test_distill_spec_normalization_matches_jax(d):
    got, want = normalize_distill(d), j_normalize(d)
    if want is None:
        assert got is None
    else:
        assert got == DistillSpec(**want.__dict__)
    spec = DistillSpec(every=2)
    assert normalize_distill(spec) is spec


@pytest.mark.parametrize("kw", [
    {"optimizer": "lion"}, {"schedule": "linear"},
    {"harvest": 9, "buffer": 4}, {"lr": 0.0}, {"every": 0},
    {"buffer": 0}, {"harvest": 0}])
def test_distill_spec_validation_matches_jax(kw):
    with pytest.raises(ValueError) as want:
        JDistill(**kw)
    with pytest.raises(ValueError) as got:
        DistillSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("distill,metrics", [
    (True, True), ({"lr": 0.01, "every": 2}, {"rank": False}),
    ({"enabled": False}, None), (None, {"enabled": False})])
def test_spec_json_round_trip_with_distill_and_metrics(distill, metrics):
    s = JSpec(provider="detector", n_cameras=2, distill=distill,
              metrics=metrics).to_json()
    spec = TSpec.from_json(s)
    assert json.loads(spec.to_json()) == json.loads(s)
    assert TSpec.from_json(spec.to_json()) == spec
    back = JSpec.from_json(spec.to_json())
    assert back.distill == JSpec.from_json(s).distill
    assert back.metrics == JSpec.from_json(s).metrics


# ---------------------------------------------------------------------------
# pairs: selection, teacher targets, ring writes
# ---------------------------------------------------------------------------

class _Out:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_select_sent_windows_ties_match_jax():
    """Equal pred_acc among sent cells, a chosen cell that was not the
    best, rows with fewer sent cells than the harvest: exact."""
    rng = np.random.default_rng(0)
    f, n, z, h = 6, 25, 3, 4
    sent = rng.random((f, n)) < 0.3
    sent[4] = False
    sent[5, :2] = True
    sent[5, 2:] = False
    pred = np.round(rng.random((f, n)) * 4) / 4          # many ties
    pred = pred.astype(np.float32)
    chosen = rng.integers(0, n, f)
    chosen[0] = np.flatnonzero(sent[0])[-1]
    sent[np.arange(f), chosen] |= np.arange(f) < 3
    zooms = rng.integers(0, z, (f, n))
    jw, jok = jpairs.select_sent_windows(_Out(
        sent=jnp.asarray(sent), pred_acc=jnp.asarray(pred),
        chosen=jnp.asarray(chosen, jnp.int32),
        zooms=jnp.asarray(zooms, jnp.int32)), z, h)
    tw, tok = tpairs.select_sent_windows(_Out(
        sent=torch.as_tensor(sent), pred_acc=torch.as_tensor(pred),
        chosen=t(chosen), zooms=t(zooms)), z, h)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert not tok[4].any() and tok[5].sum() == 2


def _target_inputs(seed):
    """A seeded 3-camera scene with area ties (object 1 a copy of object
    0, object 16 a copy of object 15: equal boxes, a person and a car),
    windows drawn from the grid; -> (numpy state, window ids, pairs)."""
    st = oracle_state(3, 14, 8, seed, enabled_p=0.9)
    for a, b in ((0, 1), (15, 16), (0, 14)):
        st["pos"][:, b] = st["pos"][:, a]
        st["size"][:, b] = st["size"][:, a]
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, 75, (3, 4))
    return st, sel


def _jax_targets(st, sel, max_boxes):
    from repro.core import Query, Workload
    from repro.core.grid import DEFAULT_GRID
    from repro.fleet.state import workload_spec

    jspec = jscene.SceneSpec(max_people=14, max_cars=8)
    sw = workload_spec(Workload(tuple(
        Query(*q) for q in ORACLE_WORKLOADS[4])))
    f, m = st["oid"].shape
    zeros2 = jnp.zeros((f, m, 2), jnp.float32)
    state = jscene.SceneState(
        pos=jnp.asarray(st["pos"]), vel=zeros2, size=jnp.asarray(st["size"]),
        waypoint=zeros2, oid=jnp.asarray(st["oid"], jnp.int32),
        next_id=jnp.full((f,), m, jnp.int32))
    zf = jnp.zeros(f, jnp.float32)
    params = jscene.SceneFleetParams(
        person_speed=zf, car_speed=zf, churn=zf,
        poi=jnp.zeros((f, jspec.n_poi, 2), jnp.float32),
        enabled=jnp.asarray(st["enabled"]))
    wins = jobs.grid_windows(DEFAULT_GRID)[jnp.asarray(sel)]
    return jpairs.teacher_window_targets(
        jspec, jobs.teacher_arrays(sw.pairs), params, state,
        jnp.asarray(st["t"], jnp.int32), wins, max_boxes,
        jnp.asarray(st["cam_salt"].astype(np.uint32)))


def _port_targets(st, sel, max_boxes):
    tspec = TSceneSpec(max_people=14, max_cars=8)
    (spec, teach, params, state, tt, windows), kw = oracle_args(st, tspec,
                                                                4)
    return tpairs.teacher_window_targets(
        spec, teach, params, state, tt, windows[t(sel)], max_boxes,
        kw["cam_salt"])


@pytest.mark.parametrize("seed", [1, 2])
def test_teacher_window_targets_match_jax(seed):
    """Classes and validity exact, boxes 1e-6; every window's invalid
    rows (fewer detections than max_boxes) included; the area ties pick
    the lower slot first on both sides."""
    st, sel = _target_inputs(seed)
    want = [np.asarray(x) for x in _jax_targets(st, sel, 8)]
    got = [x.numpy() for x in _port_targets(st, sel, 8)]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    assert want[2].any() and not want[2].all()


def test_teacher_window_targets_pad_past_object_slots():
    """max_boxes above the scene's 22 slots (full madeye-approx takes 32;
    the reference's top_k refuses k > M): the first M rows are the
    M-row result, the rest invalid zeros."""
    st, sel = _target_inputs(3)
    want = [np.asarray(x) for x in _jax_targets(st, sel, 22)]
    got = [x.numpy() for x in _port_targets(st, sel, 32)]
    np.testing.assert_array_equal(got[2][..., :22], want[2])
    np.testing.assert_array_equal(got[1][..., :22], want[1])
    np.testing.assert_allclose(got[0][..., :22, :], want[0], atol=1e-6)
    assert not got[2][..., 22:].any()
    assert not got[0][..., 22:, :].any() and not got[1][..., 22:].any()


def test_harvest_into_buffer_matches_jax():
    """Dropped rows (ok=False, or a window not in the staged set), a ring
    that wraps, a camera that writes nothing: every field exact."""
    rng = np.random.default_rng(0)
    f, k, b, h, mb = 4, 6, 4, 3, 5
    staged = rng.normal(size=(f, k, 7)).astype(np.float32)
    widx = rng.permuted(np.tile(np.arange(k), (f, 1)), axis=1)
    sel = widx[:, :h].copy()
    sel[1, 2] = 99                                   # not staged: dropped
    ok = np.array([[True, True, True], [True, False, True],
                   [False, False, False], [True, True, False]])
    boxes = rng.normal(size=(f, h, mb, 4)).astype(np.float32)
    cls = rng.integers(0, 2, (f, h, mb))
    val = rng.random((f, h, mb)) > 0.5
    ptr = np.array([3, 0, 1, 2])

    jbuf = jpairs.init_pair_buffer(f, b, (7,), mb)
    jbuf = jbuf._replace(ptr=jnp.asarray(ptr, jnp.int32),
                         weight=jbuf.weight.at[0, 1].set(1.0))
    tbuf = tpairs.init_pair_buffer(f, b, (7,), mb)
    tbuf = tbuf._replace(ptr=t(ptr), weight=t(np.asarray(jbuf.weight)))
    for _ in range(2):                  # twice: the second pass wraps
        jbuf = jpairs.harvest_into_buffer(
            jbuf, jnp.asarray(staged), jnp.asarray(widx, jnp.int32),
            jnp.asarray(sel, jnp.int32), jnp.asarray(ok), jnp.asarray(boxes),
            jnp.asarray(cls, jnp.int32), jnp.asarray(val))
        tbuf = tpairs.harvest_into_buffer(
            tbuf, t(staged), t(widx), t(sel), t(ok), t(boxes), t(cls), t(val))
        for name in tpairs.PairBuffer._fields:
            np.testing.assert_array_equal(getattr(tbuf, name).numpy(),
                                          np.asarray(getattr(jbuf, name)),
                                          err_msg=name)
    assert int(tbuf.ptr[2]) == 1 and float(tbuf.weight[2].sum()) == 0.0


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def _loss_inputs(seed, b=3):
    """Raw head outputs and targets at smoke width (g = 4): slot 0 of
    sample 0 a valid GT in cell 0 followed by padding; slots 1 and 2 of
    sample 1 two valid GTs in one cell (the later one must win); sample
    2 all padding."""
    rng = np.random.default_rng(seed)
    g, k, n = 4, 2, 6
    cls = rng.normal(size=(b, g, g, k)).astype(np.float32)
    box = rng.normal(size=(b, g, g, 4)).astype(np.float32)
    obj = rng.normal(size=(b, g, g)).astype(np.float32)
    gtb = rng.uniform(0.05, 0.95, (b, n, 4)).astype(np.float32)
    gtc = rng.integers(0, k, (b, n))
    val = rng.random((b, n)) < 0.6
    gtb[0, 0, :2] = 0.1                     # cell 0
    gtc[0, 0] = 1
    val[0] = [True] + [False] * (n - 1)
    gtb[1, 1, :2] = 0.6, 0.6                # slots 1 and 2: cell (2, 2)
    gtb[1, 2, :2] = 0.62, 0.61
    gtc[1, 1], gtc[1, 2] = 0, 1
    val[1, 1:3] = True
    val[2:] = False
    w = np.array([1.0, 0.5, 0.0], np.float32)[:b]
    return cls, box, obj, gtb, gtc, val, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_detector_loss_from_outputs_matches_jax(weighted, seed):
    cls, box, obj, gtb, gtc, val, w = _loss_inputs(seed)
    want = jdet.detector_loss_from_outputs(
        *map(jnp.asarray, (cls, box, obj, gtb)), jnp.asarray(gtc, jnp.int32),
        jnp.asarray(val), weight=jnp.asarray(w) if weighted else None)
    got = tdet.detector_loss_from_outputs(
        *map(t, (cls, box, obj, gtb, gtc, val)),
        weight=t(w) if weighted else None)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_loss_scatter_takes_the_last_slot():
    """The dense targets the reference's scatter builds on the CPU: a
    valid GT in cell 0 followed by padding keeps its class; of two valid
    GTs in one cell the later slot's class and box win (a swapped order
    changes the loss, so the loss pins the rule)."""
    cls, box, obj, gtb, gtc, val, _ = _loss_inputs(0, b=2)
    args = [t(cls), t(box), t(obj)]

    def loss(boxes, classes):
        return float(tdet.detector_loss_from_outputs(
            *args, t(boxes), t(classes), t(val)))

    def jloss(boxes, classes):
        return float(jdet.detector_loss_from_outputs(
            *map(jnp.asarray, (cls, box, obj, boxes)),
            jnp.asarray(classes, jnp.int32), jnp.asarray(val)))

    swapped_b, swapped_c = gtb.copy(), gtc.copy()
    swapped_b[1, [1, 2]] = gtb[1, [2, 1]]
    swapped_c[1, [1, 2]] = gtc[1, [2, 1]]
    assert loss(gtb, gtc) != loss(swapped_b, swapped_c)
    for b_, c_ in ((gtb, gtc), (swapped_b, swapped_c)):
        np.testing.assert_allclose(loss(b_, c_), jloss(b_, c_), rtol=1e-5)


# ---------------------------------------------------------------------------
# one distill_update from an identical LearnState
# ---------------------------------------------------------------------------

def _jax_learn_state(dspec, seed, f=2, k=3):
    """The JAX package's init_learn with a seeded, partly filled ring
    (camera 0 full, camera 1 half, one all-invalid slot)."""
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(jnp.asarray, init_np(seed))
    lc = jloop.init_learn(dspec, JCFG, jp, f, k)
    buf = lc.buf
    fb, b = buf.weight.shape
    weight = np.ones((fb, b), np.float32)
    weight[1, b // 2:] = 0.0
    valid = rng.random(buf.valid.shape) < 0.5
    valid[0, 1] = False
    boxes = rng.uniform(0.05, 0.95, buf.boxes.shape).astype(np.float32)
    boxes[..., 2:] *= 0.3
    lc = lc._replace(buf=buf._replace(
        x=jnp.asarray(rng.normal(size=buf.x.shape).astype(np.float32)),
        boxes=jnp.asarray(boxes),
        classes=jnp.asarray(rng.integers(0, 2, buf.classes.shape),
                            jnp.int32),
        valid=jnp.asarray(valid), weight=jnp.asarray(weight)))
    return jp, lc


def _to_port(dspec, lc):
    def tree(x):
        return tdet.params_from_numpy(jax.tree.map(np.asarray, x))

    step = torch.tensor(int(lc.opt.step), dtype=torch.int32)
    if dspec.optimizer == "adamw":
        opt = toptim.AdamState(step, tree(lc.opt.mu), tree(lc.opt.nu))
    else:
        opt = toptim.SGDState(step, tree(lc.opt.momentum))
    buf = lc.buf
    return tloop.LearnState(
        params=tree(lc.params), opt=opt,
        buf=tpairs.PairBuffer(t(buf.x).float(), t(buf.boxes).float(),
                              t(buf.classes), t(buf.valid), t(buf.weight),
                              t(buf.ptr)),
        staged=t(lc.staged).float(), staged_widx=t(lc.staged_widx))


UPDATES = {
    "head-adamw": dict(),
    "head-sgd": dict(optimizer="sgd", lr=0.05),
    "full-adamw": dict(head_only=False, weight_decay=0.01),
    "full-sgd": dict(head_only=False, optimizer="sgd", lr=0.05),
    "head-adamw-cosine": dict(schedule="cosine", warmup=2, horizon=5,
                              weight_decay=0.01),
}


# one compiled program per variant (eager JAX compiles every primitive
# of the ViT's backward on its own, which takes longer)
_j_update = jax.jit(jloop.distill_update, static_argnums=(0, 1))


def _roundoff_elements(mu_old, mu_new, noise, b1=0.9):
    """Accumulate the elements whose gradient this update, g = (mu_new -
    b1 mu_old) / (1 - b1), is at float32 round-off level (|g| < 1e-5,
    against gradients up to ~4e-2 here; e.g. the attention key bias,
    whose gradient is zero but for round-off)."""
    g = [np.abs((n - b1 * o) / (1 - b1)) for o, n in zip(
        toptim.tree_leaves(tree_np(mu_old)),
        toptim.tree_leaves(tree_np(mu_new)))]
    if noise is None:
        return [x < 1e-5 for x in g]
    return [a | (x < 1e-5) for a, x in zip(noise, g)]


@pytest.mark.parametrize("name", list(UPDATES))
def test_distill_update_matches_jax(name):
    """Two updates from the same LearnState on both sides (the second
    with non-zero moments): per-camera loss, params and moments.

    AdamW divides each element's first moment by the root of its second:
    an element whose gradient is at round-off level steps by up to ~lr
    either way on either side, whatever its sign noise. Such elements
    (few: see `_roundoff_elements`) are held to 3 lr per update; every
    other element to 1e-6, or 3e-6 in full mode (its gradients come
    back through two transformer layers of float32 sums in another
    order than XLA's)."""
    kw = UPDATES[name]
    jd, td = JDistill(**kw), DistillSpec(**kw)
    tol = 1e-6 if td.head_only else 3e-6
    _, jlc = _jax_learn_state(jd, seed=len(name))
    tlc = _to_port(td, jlc)
    noise = None
    for it in range(1, 3):
        j_old = jlc
        jlc, jloss = _j_update(jd, JCFG, jlc)
        with torch.no_grad():
            tlc, tloss = tloop.distill_update(td, TCFG, tlc)
        np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss),
                                   rtol=1e-5)
        assert int(tlc.opt.step) == int(jlc.opt.step)
        if td.optimizer == "adamw":
            assert_tree_close(tlc.opt.mu, jlc.opt.mu, atol=1e-6)
            assert_tree_close(tlc.opt.nu, jlc.opt.nu, atol=1e-9)
            noise = _roundoff_elements(j_old.opt.mu, jlc.opt.mu, noise)
            for got, want, rough in zip(
                    toptim.tree_leaves(tree_np(tlc.params)),
                    toptim.tree_leaves(tree_np(jlc.params)), noise):
                if rough.ndim == 0:         # a masked leaf: no moments
                    np.testing.assert_array_equal(got, want)
                    continue
                err = np.abs(got - want)
                assert (err[~rough] <= tol).all(), err[~rough].max()
                assert (err[rough] <= 3 * td.lr * it).all()
            n_rough = sum(int(r.sum()) for r in noise)
            n_all = sum(r.size for r in noise if r.ndim)
            assert n_rough <= 0.02 * n_all, (n_rough, n_all)
        else:
            assert_tree_close(tlc.params, jlc.params, atol=tol)
            assert_tree_close(tlc.opt.momentum, jlc.opt.momentum,
                              atol=1e-6)
    assert float(tloss[1]) >= 0.0       # the half-filled ring trains


def test_head_params_mask_matches_jax():
    jp = jax.tree.map(jnp.asarray, init_np(0))
    want = jax.tree.map(bool, jdet.head_params_mask(jp))
    assert tdet.head_params_mask(tdet.params_from_numpy(init_np(0))) == want


@pytest.mark.parametrize("step", range(7))
def test_lr_schedule_matches_jax(step):
    kw = dict(schedule="cosine", warmup=2, horizon=5)
    want = float(jloop.lr_at(JDistill(**kw), jnp.asarray(step, jnp.int32)))
    got = float(tloop.lr_at(DistillSpec(**kw),
                            torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-12)
    assert float(tloop.lr_at(DistillSpec(), torch.tensor(step))) == \
        float(jloop.lr_at(JDistill(), step))


@pytest.mark.parametrize("head_only", [True, False])
def test_idle_camera_is_bit_exact_noop(head_only):
    """A camera whose ring is empty passes distill_update with params
    AND moments bit-unchanged (weight decay must not drift it) and the
    -1 loss sentinel; the other camera moves. Full mode keeps the
    patch embedding bit-unchanged on every camera."""
    d = DistillSpec(head_only=head_only, weight_decay=0.01)
    _, jlc = _jax_learn_state(JDistill(head_only=head_only), seed=7)
    lc = _to_port(d, jlc)
    lc = lc._replace(buf=lc.buf._replace(
        weight=lc.buf.weight * torch.tensor([[1.0], [0.0]])))
    before = tree_np(lc.params), tree_np(lc.opt.mu), tree_np(lc.opt.nu)
    for _ in range(2):
        lc, loss = tloop.distill_update(d, TCFG, lc)
    assert float(loss[0]) >= 0.0 and float(loss[1]) == -1.0
    for old, new in zip(before, (lc.params, lc.opt.mu, lc.opt.nu)):
        new = tree_np(new)
        for a, b in zip(toptim.tree_leaves(old), toptim.tree_leaves(new)):
            if a.ndim == 0:             # masked leaves carry no state
                continue
            np.testing.assert_array_equal(b[1], a[1])
    moved = [not np.array_equal(a[0], b[0]) for a, b in zip(
        toptim.tree_leaves(before[0]), toptim.tree_leaves(tree_np(lc.params)))]
    assert any(moved)
    if not head_only:
        assert_tree_equal(lc.params["backbone"]["vit"]["patch_embed"],
                          before[0]["backbone"]["vit"]["patch_embed"])


# ---------------------------------------------------------------------------
# the learning episode through run_fleet
# ---------------------------------------------------------------------------

def test_learning_episode_decisions_match_jax(runs):
    want, got = runs
    assert got.chosen == want.chosen
    assert got.frames_sent == want.frames_sent
    for k in ("explored", "order", "zooms", "sent", "chosen"):
        np.testing.assert_array_equal(getattr(got.out, k).numpy(),
                                      np.asarray(getattr(want.out, k)),
                                      err_msg=k)
    np.testing.assert_allclose(got.out.pred_acc.numpy(),
                               np.asarray(want.out.pred_acc), atol=1e-5)
    np.testing.assert_allclose(got.acc_per_step, want.acc_per_step,
                               atol=1e-6)


def test_learning_episode_loss_and_heads_match_jax(runs):
    want, got = runs
    assert len(got.distill_loss) == N_STEPS
    assert all(v >= 0 for v in got.distill_loss)
    np.testing.assert_allclose(got.distill_loss, want.distill_loss,
                               rtol=1e-5)
    # AdamW: an element whose gradient falls to round-off level at some
    # step takes a noise-signed step of up to ~lr on each side (see
    # test_distill_update_matches_jax), so 98% of the elements are held
    # to 2e-6 and every element to 3 lr per update
    lr = DistillSpec().lr
    errs = np.concatenate([np.abs(a - b).reshape(-1) for a, b in zip(
        toptim.tree_leaves(tree_np(got.learned_params(None)["heads"])),
        toptim.tree_leaves(tree_np(want.learned_params(None)["heads"])))])
    assert (errs <= 2e-6).mean() >= 0.98, np.sort(errs)[-10:]
    assert errs.max() <= 3 * lr * N_STEPS


def test_learning_episode_metrics_match_jax(runs):
    want, got = runs
    assert sorted(got.metrics) == sorted(want.metrics)
    for k, v in want.metrics.items():
        a, b = np.asarray(v), got.metrics[k].numpy()
        assert b.shape == a.shape == (N_STEPS, 2), k
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5,
                                       err_msg=k)
    from repro.obs.metrics import summarize_metrics as j_summarize

    s_got, s_want = summarize_metrics(got.metrics), j_summarize(want.metrics)
    assert sorted(s_got) == sorted(s_want)
    assert s_got["chosen_rank_median"] == s_want["chosen_rank_median"]
    np.testing.assert_allclose(s_got["distill_loss_mean"],
                               s_want["distill_loss_mean"], rtol=1e-5)
    assert median_valid_rank(got.metrics["chosen_rank"]) >= 1.0


def test_learning_episode_backbone_bit_unchanged(runs):
    _, got = runs
    provider, _ = got.learned
    learned = got.learned_params(0)
    assert_tree_equal(learned["backbone"], provider.det_params["backbone"])
    moved = [not np.array_equal(a, b) for a, b in zip(
        toptim.tree_leaves(tree_np(learned["heads"])),
        toptim.tree_leaves(tree_np(provider.det_params["heads"])))]
    assert any(moved)


def test_learned_params_npz_round_trip(runs, tmp_path):
    """save_learned_params writes the reference's key layout: repro's
    load_detector_params and the port's read it back."""
    _, got = runs
    path = got.save_learned_params(str(tmp_path / "cam1.npz"), camera=1)
    want = got.learned_params(1)
    assert_tree_equal(tree_np(load_detector_params(path)), want)
    assert_tree_equal(jax.tree.map(np.asarray, j_load_detector_params(path)),
                      want)


def test_result_json_drops_learning_payload(runs):
    _, got = runs
    d = json.loads(got.to_json())
    assert "learned" not in d and "metrics" not in d
    back = FleetResult.from_json(got.to_json())
    assert back.distill_loss == got.distill_loss
    assert back.learned is None and back.spec.distill == DistillSpec()
    assert back.spec.metrics == MetricsSpec()


def test_distill_off_is_the_frozen_run(weights_npz):
    """distill=None / False / {"enabled": False} run the frozen episode
    bit for bit, with no learning surface on the result; metrics on
    change no decision."""
    def go(distill, metrics=None):
        return t_run_fleet(TSpec(**_spec_kw(weights_npz, distill,
                                            metrics=metrics,
                                            n_steps=4)), device="cpu")

    base = go(None)
    for r in (go(False), go({"enabled": False}), go(None, True)):
        for k in base.out._fields:
            np.testing.assert_array_equal(getattr(r.out, k).numpy(),
                                          getattr(base.out, k).numpy())
        assert r.distill_loss is None and r.learned is None
        with pytest.raises(ValueError, match="distill"):
            r.learned_params()


def test_cadence_gate_every_2(weights_npz):
    """every=2 updates on steps 2, 4, ... (1-based): the host's e + 1
    gates it, and that equals the state's step_idx after each step."""
    prep = prepare_fleet_run(TSpec(**_spec_kw(
        weights_npz, {"every": 2}, metrics=None, n_steps=4)), device="cpu")
    state, carry = prep.state, prep.provider.init_carry(prep.state)
    losses = []
    with torch.no_grad():
        for e in range(4):
            state, carry, _, ex = episode_step(
                prep.cfg, prep.wl, prep.statics, state, prep.provider,
                carry, e)
            assert (state.step_idx == e + 1).all()
            losses.append(ex["learn"]["loss"])
    loss = torch.stack(losses).numpy()
    assert (loss[[0, 2]] == -1.0).all() and (loss[[1, 3]] >= 0.0).all()
    assert int(carry[2].opt.step) == 2


def test_distill_run_never_falls_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_run_fleet(TSpec(provider="detector", n_cameras=1, n_steps=1,
                          distill=True, metrics=True))


def test_distill_needs_the_detector_provider():
    with pytest.raises(TypeError):
        t_run_fleet(TSpec(provider="scene", n_cameras=1, n_steps=1,
                          distill=True), device="cpu")
    with pytest.raises(ValueError, match="harvest"):
        t_run_fleet(TSpec(provider="detector", n_cameras=1, n_steps=1,
                          distill={"harvest": 26, "buffer": 32}),
                    device="cpu")
