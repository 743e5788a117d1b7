"""The port's scene, oracle pass and render pieces against the JAX
package, on the same seeds and the same states.

Tolerances: object ids, enabled flags, hash draws, counts, box counts
and oracle accuracy are exact. Positions, velocities and sizes drift by
float32 round-off: the normal draws go through erfinv, whose log1p
rounds differently in the last bit now and then, and XLA contracts some
multiply-adds the port rounds twice — so trajectories are held to
1e-4 absolute (scene degrees, values up to 150) over the steps run here.
Geometry sums (centroid, extent, areas) are held to 1e-5 relative;
the spread, a cancelling difference of moments, is held as a variance
(see test_observe_all_cells_match).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.grid import DEFAULT_GRID  # noqa: E402
from repro.fleet.state import workload_spec as j_workload_spec  # noqa: E402
from repro.core import Query, Workload  # noqa: E402
from repro.scene_jax import observe as jobs  # noqa: E402
from repro.scene_jax import render as jrender  # noqa: E402
from repro.scene_jax import scene as jscene  # noqa: E402
from repro_torch.scene import observe as tobs  # noqa: E402
from repro_torch.scene import render as trender  # noqa: E402
from repro_torch.scene import scene as tscene  # noqa: E402

F = 3
STRIDE = 2
STEPS = 5
WORKLOAD = Workload((
    Query("yolov4", "person", "count"),
    Query("ssd", "car", "detect"),
    Query("frcnn", "person", "binary"),
    Query("tiny-yolov4", "person", "agg_count"),
))


def tn(x):
    a = np.asarray(x)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.as_tensor(a.copy())


def to_torch_state(s):
    return tscene.SceneState(*(tn(x) for x in s))


def assert_states_close(got, want):
    np.testing.assert_array_equal(got.oid.numpy(), np.asarray(want.oid))
    np.testing.assert_array_equal(got.next_id.numpy(),
                                  np.asarray(want.next_id))
    for name in ("pos", "vel", "size", "waypoint"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-4, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def scenes():
    """The same heterogeneous fleet stepped by both packages."""
    kw = dict(seed=3, scene_seeds=[5, 11, 2], person_speed=[1.2, 2.0, 0.8],
              car_speed=10.0, churn=[0.01, 0.2, 0.05], n_people=[14, 6, 10],
              n_cars=[8, 3, 0])
    jspec, tspec = jscene.SceneSpec(), tscene.SceneSpec()
    jp, jrng = jscene.scene_fleet_params(jspec, F, **kw)
    tp, trng = tscene.scene_fleet_params(tspec, F, **kw)
    js, ts = [jscene.init_scene(jspec, jp, jrng)], [
        tscene.init_scene(tspec, tp, trng)]
    for step in range(STEPS):
        js.append(jscene.advance_scene(jspec, jp, jrng, js[-1], step,
                                       STRIDE))
        ts.append(tscene.advance_scene(tspec, tp, trng, ts[-1], step,
                                       STRIDE))
    return dict(jspec=jspec, tspec=tspec, jp=jp, tp=tp, jrng=jrng,
                trng=trng, js=js, ts=ts)


def test_fleet_params_and_keys_equal(scenes):
    np.testing.assert_array_equal(scenes["trng"].numpy(),
                                  np.asarray(scenes["jrng"], np.int64))
    for name in scenes["jp"]._fields:
        np.testing.assert_array_equal(
            getattr(scenes["tp"], name).numpy(),
            np.asarray(getattr(scenes["jp"], name)), err_msg=name)


@pytest.mark.parametrize("step", range(STEPS + 1))
def test_trajectories_match(scenes, step):
    assert_states_close(scenes["ts"][step], scenes["js"][step])


def test_trajectories_respawn():
    """The compared stretch includes respawns (fresh ids), so the churn
    and car-exit paths are exercised, not only the random walk."""
    jspec = jscene.SceneSpec()
    jp, jrng = jscene.scene_fleet_params(jspec, 2, seed=1, churn=0.5)
    tp, trng = tscene.scene_fleet_params(tscene.SceneSpec(), 2, seed=1,
                                         churn=0.5)
    js = jscene.init_scene(jspec, jp, jrng)
    ts = tscene.init_scene(tscene.SceneSpec(), tp, trng)
    for step in range(3):
        js = jscene.advance_scene(jspec, jp, jrng, js, step, 1)
        ts = tscene.advance_scene(tscene.SceneSpec(), tp, trng, ts, step, 1)
    assert int(np.asarray(js.next_id).min()) > jspec.max_objects
    assert_states_close(ts, js)


def test_hash01_equal():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 31 - 1, (4, 1, 7))
    b = rng.integers(0, 2 ** 32, (1, 5, 1), dtype=np.uint64)
    c = rng.integers(0, 100, (4, 5, 7))
    want = jobs.hash01(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.uint32),
                       jnp.asarray(c, jnp.int32), jnp.uint32(0xBA5E))
    got = tobs.hash01(tn(a), tn(b.astype(np.int64)), tn(c), 0xBA5E)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_teacher_arrays_equal():
    pairs = j_workload_spec(WORKLOAD).pairs
    want = jobs.teacher_arrays(pairs)
    got = tobs.teacher_arrays(pairs)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("step", [1, STEPS])
def test_observe_all_cells_match(scenes, step):
    """The oracle pass on one SceneState (the JAX one, converted)."""
    sw = j_workload_spec(WORKLOAD)
    js = scenes["js"][step]
    t = np.full(F, step * STRIDE, np.int32)
    salt = np.asarray(scenes["jrng"])[:, 0]
    win = jobs.grid_windows(DEFAULT_GRID)
    want = jobs.observe_all_cells(
        scenes["jspec"], jobs.teacher_arrays(sw.pairs), scenes["jp"], js,
        jnp.asarray(t), win, task_id=sw.task_id, pair_idx=sw.pair_idx,
        cam_salt=jnp.asarray(salt))
    got = tobs.observe_all_cells(
        scenes["tspec"], tobs.teacher_arrays(sw.pairs), scenes["tp"],
        to_torch_state(js), tn(t), tobs.grid_windows(DEFAULT_GRID),
        task_id=sw.task_id, pair_idx=sw.pair_idx, cam_salt=tn(salt))
    assert float(np.asarray(want.counts).sum()) > 0
    for name in ("counts", "nbox", "acc_true"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("areas", "centroid", "extent"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    # spread = sqrt(E[c^2] - |E[c]|^2) cancels: E[c^2] reaches ~3e4
    # deg^2, so sums taken in another order move the variance by a few
    # ulps of that (~1e-2 deg^2) — compared as a variance
    np.testing.assert_allclose(got.spread.numpy() ** 2,
                               np.asarray(want.spread) ** 2, atol=1e-2,
                               rtol=1e-5)


def test_render_pieces_match(scenes):
    np.testing.assert_array_equal(trender.render_background(64).numpy(),
                                  np.asarray(jrender.render_background(64)))
    kind = jscene.kind_mask(scenes["jspec"])
    oid = scenes["js"][-1].oid
    np.testing.assert_array_equal(
        trender.object_colors(tn(kind), tn(oid)).numpy(),
        np.asarray(jrender.object_colors(jnp.asarray(kind), oid)))
    frame = jnp.full(F, 6, jnp.int32)
    # normal draws: erfinv's last-bit differences only (see module doc)
    np.testing.assert_allclose(
        trender.render_noise(scenes["trng"], tn(frame), 32).numpy(),
        np.asarray(jrender.render_noise(scenes["jrng"], frame, 32)),
        atol=2e-6, rtol=0)


@pytest.mark.parametrize("overrides", [{}, {"max_people": 20, "n_poi": 5}])
def test_fleet_from_config_matches(overrides):
    """fleet_from_config ports a numpy SceneConfig (geometry and
    dynamics) as the reference's does: the spec's shared fields, the
    per-camera params and the camera keys are equal."""
    from repro.data.scene import SceneConfig as JConfig
    from repro_torch.data.scene import SceneConfig as TConfig

    kw = dict(extent=(140.0, 70.0), n_people=9, n_cars=5, n_poi=4,
              person_speed=1.7, car_speed=12.0, churn=0.03,
              lane_tilts=(18.0, 30.0))
    jspec, jp, jrng = jscene.fleet_from_config(
        JConfig(**kw), F, seed=6, scene_seeds=[4, 1, 9], **overrides)
    tspec, tp, trng = tscene.fleet_from_config(
        TConfig(**kw), F, seed=6, scene_seeds=[4, 1, 9], **overrides)
    for name in tscene.SceneSpec.__dataclass_fields__:
        assert getattr(tspec, name) == getattr(jspec, name), name
    np.testing.assert_array_equal(trng.numpy(), np.asarray(jrng, np.int64))
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
