"""The port's controller step (fleet/state, shape_ops, step) against the
JAX package: the same FleetState and the same FleetObs stream, stepped
side by side by both packages for several steps, with each package
carrying its own state forward.

Every FleetStepOut field and every state leaf is equal, except the
float ones derived by division (pred_acc, path_time, the EWMA labels):
those are held to 1e-5 (XLA contracts some multiply-adds and turns
division by a constant into a product; the port rounds each op).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import DEFAULT_GRID, Query, Workload  # noqa: E402
from repro.core.tradeoff import BudgetConfig  # noqa: E402
from repro.fleet import shape_ops as jshape  # noqa: E402
from repro.fleet import state as jstate  # noqa: E402
from repro.fleet import step as jstep  # noqa: E402
from repro_torch.core import Query as TQuery  # noqa: E402
from repro_torch.core import Workload as TWorkload  # noqa: E402
from repro_torch.core.tradeoff import BudgetConfig as TBudget  # noqa: E402
from repro_torch.fleet import shape_ops as tshape  # noqa: E402
from repro_torch.fleet import state as tstate  # noqa: E402
from repro_torch.fleet import step as tstep  # noqa: E402

QUERIES = (("yolov4", "person", "count"), ("ssd", "car", "detect"),
           ("frcnn", "person", "binary"), ("tiny-yolov4", "person",
                                           "agg_count"))
F = 4
STEPS = 6
FLOAT_TOL = ("pred_acc", "path_time")


def tn(x):
    a = np.asarray(x)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.as_tensor(a.copy())


def _obs_stream(seed, n_steps, n, z=3, p=3):
    """Random per-camera observation tables: integer counts, box counts,
    areas, centroids near the cell centers, oracle accuracies."""
    rng = np.random.default_rng(seed)
    centers = np.asarray(DEFAULT_GRID.centers, np.float32)
    for _ in range(n_steps):
        counts = rng.poisson(1.2, (F, n, z, p)).astype(np.float32)
        counts[rng.random((F, n, z, p)) < 0.4] = 0.0
        nbox = counts.max(-1).astype(np.int32)
        yield dict(
            counts=counts,
            areas=(counts * rng.uniform(0.005, 0.05, counts.shape)
                   ).astype(np.float32),
            centroid=(centers[None, :, None] + rng.normal(
                0, 6, (F, n, z, 2))).astype(np.float32),
            spread=rng.uniform(0, 8, (F, n, z)).astype(np.float32),
            extent=rng.uniform(1, 9, (F, n, z)).astype(np.float32),
            nbox=nbox,
            acc_true=rng.uniform(0, 1, (F, n, z)).astype(np.float32),
            mbps=rng.uniform(6, 40, F).astype(np.float32),
            rtt=np.float32(0.02))


def _compare_out(got, want, step):
    for name in want._fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        if name in FLOAT_TOL:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} @ step {step}")
        else:
            np.testing.assert_array_equal(g, w,
                                          err_msg=f"{name} @ step {step}")


def _compare_state(got, want):
    np.testing.assert_array_equal(got.shape.numpy(), np.asarray(want.shape))
    for name in ("current_cell", "zoom_idx", "has_boxes", "nb_has",
                 "saw_objects", "step_idx", "last_visit", "net_count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for a, b in zip(got.ewma, want.ewma):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("fps,seed", [(15.0, 0), (2.0, 1)])
def test_fleet_step_sequence_matches(fps, seed):
    """fps 15 is the default budget (one cell a step); fps 2 gives
    multi-cell shapes, so evolve/resize/shrink-to-budget all run."""
    wl = Workload(tuple(Query(*q) for q in QUERIES))
    twl = TWorkload(tuple(TQuery(*q) for q in QUERIES))
    jcfg = jstate.fleet_config(DEFAULT_GRID, BudgetConfig(fps=fps))
    tcfg = tstate.fleet_config(DEFAULT_GRID, TBudget(fps=fps))
    jsw, tsw = jstate.workload_spec(wl), tstate.workload_spec(twl)
    assert tuple(jsw) == tuple(tsw)
    jst = jstate.fleet_statics(DEFAULT_GRID)
    tst = tstate.fleet_statics(DEFAULT_GRID)
    js = jstate.init_fleet(DEFAULT_GRID, F, seed_size=6)
    ts = tstate.init_fleet(DEFAULT_GRID, F, seed_size=6)
    n = DEFAULT_GRID.n_cells
    sizes = []
    for step, o in enumerate(_obs_stream(seed, STEPS, n,
                                         p=len(jsw.pairs))):
        jobs = jstep.FleetObs(**{k: jnp.asarray(v) for k, v in o.items()})
        tobs = tstep.FleetObs(**{k: tn(v) for k, v in o.items()})
        js, jout = jstep.fleet_step(jcfg, jsw, jst, js, jobs)
        ts, tout = tstep.fleet_step(tcfg, tsw, tst, ts, tobs)
        _compare_out(tout, jout, step)
        _compare_state(ts, js)
        sizes.append(int(np.asarray(jout.n_explored).max()))
    if fps < 15:
        assert max(sizes) > 1


def test_init_fleet_and_statics_equal():
    js = jstate.init_fleet(DEFAULT_GRID, 3, seed_size=6, seed=4,
                           cam_seeds=[9, 1, 5])
    ts = tstate.init_fleet(DEFAULT_GRID, 3, seed_size=6, seed=4,
                           cam_seeds=[9, 1, 5])
    for name in js._fields[1:]:
        np.testing.assert_array_equal(
            getattr(ts, name).numpy(),
            np.asarray(getattr(js, name)).astype(
                getattr(ts, name).numpy().dtype), err_msg=name)
    jst = jstate.fleet_statics(DEFAULT_GRID)
    tst = tstate.fleet_statics(DEFAULT_GRID)
    for name in jst._fields:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)


def _random_masks(seed, f=16, p=0.4):
    rng = np.random.default_rng(seed)
    n = DEFAULT_GRID.n_cells
    mask = rng.random((f, n)) < p
    mask[0] = False                                   # empty
    mask[1] = False
    mask[1, 7] = True                                 # singleton
    labels = (rng.integers(0, 4, (f, n)) / 4 + 1e-3).astype(np.float32)
    return mask, labels


@pytest.mark.parametrize("seed", [0, 1])
def test_contiguity_and_first_removable_match(seed):
    mask, labels = _random_masks(seed)
    adj_j = jstate.fleet_statics(DEFAULT_GRID).neighbor8
    adj_t = tstate.fleet_statics(DEFAULT_GRID).neighbor8
    np.testing.assert_array_equal(
        tshape.is_contiguous(tn(mask), adj_t).numpy(),
        np.asarray(jshape.is_contiguous(jnp.asarray(mask), adj_j)))
    np.testing.assert_array_equal(
        tshape.first_removable(tn(mask), tn(labels), adj_t).numpy(),
        np.asarray(jshape.first_removable(jnp.asarray(mask),
                                          jnp.asarray(labels), adj_j)))
    seed_cells = np.zeros_like(mask)
    seed_cells[:, 12] = True
    np.testing.assert_array_equal(
        tshape.flood_reach(tn(mask), tn(seed_cells), adj_t).numpy(),
        np.asarray(jshape.flood_reach(jnp.asarray(mask),
                                      jnp.asarray(seed_cells), adj_j)))


@pytest.mark.parametrize("seed", [0, 1])
def test_evolve_and_resize_match(seed):
    """Head/tail evolution and resize on random shapes (ties in labels
    on purpose: quantized to quarters)."""
    mask, labels = _random_masks(seed, p=0.25)
    rng = np.random.default_rng(seed + 10)
    f, n = mask.shape
    cent = (np.asarray(DEFAULT_GRID.centers, np.float32)[None]
            + rng.normal(0, 5, (f, n, 2))).astype(np.float32)
    has = rng.random((f, n)) < 0.6
    target = rng.integers(1, 9, f)
    jcfg = jstate.fleet_config(DEFAULT_GRID)
    tcfg = tstate.fleet_config(DEFAULT_GRID)
    jst = jstate.fleet_statics(DEFAULT_GRID)
    tst = tstate.fleet_statics(DEFAULT_GRID)
    jargs = [jnp.asarray(x) for x in (mask, labels, cent, has)]
    targs = [tn(x) for x in (mask, labels, cent, has)]
    jev = jshape.evolve_shape(jcfg, jst, *jargs)
    tev = tshape.evolve_shape(tcfg, tst, *targs)
    np.testing.assert_array_equal(tev.numpy(), np.asarray(jev))
    jrs = jshape.resize_shape(jcfg, jst, jev, *jargs[1:],
                              jnp.asarray(target))
    trs = tshape.resize_shape(tcfg, tst, tev, *targs[1:], tn(target))
    np.testing.assert_array_equal(trs.numpy(), np.asarray(jrs))
