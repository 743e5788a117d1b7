"""The oracle pass (`kernels/oracle_pass`) on the CPU: its plain version,
through `scene/observe.observe_all_cells`, against the JAX package's
`observe_all_cells` on the same seeded states; and numpy models of what
the CUDA kernel (`csrc/oracle_pass.cu`) computes — the hash in native
uint32 arithmetic, the double-rounded multiply-add of the spread, and
the whole pass with its counts and areas summed in object order and its
moments (of the centers about each window's center) by a warp butterfly
over chunks of 32 objects, as many as M needs — held against the plain
version. The kernel itself runs on the card only
(tests/test_torch_kernels_cuda.py).

Tolerances, as in tests/test_torch_scene.py: hash draws, counts, box
counts and oracle accuracy are exact; areas, centroids and extents are
sums in another order (1e-5); the spread, a cancelling difference of
moments, is compared as a variance (1e-2 deg^2).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import Query, Workload  # noqa: E402
from repro.core.grid import DEFAULT_GRID  # noqa: E402
from repro.fleet.state import workload_spec as j_workload_spec  # noqa: E402
from repro.scene_jax import observe as jobs  # noqa: E402
from repro.scene_jax import scene as jscene  # noqa: E402
from repro_torch.kernels.cell_rasterize.ops import window_arrays  # noqa: E402
from repro_torch.kernels.oracle_pass import ops as orc  # noqa: E402
from repro_torch.numerics import fma_f32  # noqa: E402
from repro_torch.scene import observe as tobs  # noqa: E402
from repro_torch.scene import scene as tscene  # noqa: E402
from torch_kernel_inputs import (  # noqa: E402
    ORACLE_WORKLOADS,
    oracle_args,
    oracle_state,
    oracle_variance_f64,
)

f32 = np.float32


# ---------------------------------------------------------------------------
# numpy models of the kernel's arithmetic
# ---------------------------------------------------------------------------

def hash01_np(*keys):
    """observe.hash01 as the kernel computes it: each key cut to its low
    32 bits, then wrap-around uint32 multiplies and logical shifts."""
    h = None
    with np.errstate(over="ignore"):
        for x in keys:
            x = np.asarray(x).astype(np.int64).astype(np.uint32)
            h = (np.uint32(0x811C9DC5) ^ x) if h is None else h ^ x
            h = h * np.uint32(0x9E3779B1)
            h = h ^ (h >> np.uint32(15))
            h = h * np.uint32(0x85EBCA77)
            h = h ^ (h >> np.uint32(13))
    return np.asarray(h).astype(np.float32) * f32(2.0 ** -32)


def fma_f32_np(a, b, c):
    """numerics.fma_f32 as the kernel computes it (__dmul_rn, __dadd_rn,
    __double2float_rn): the float32 product exact in double, one double
    add, one rounding to float."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def warp_tree_sum(x):
    """[F, M, C] float32 -> [F, C] as the kernel's warp sums them: each
    chunk of 32 objects (zeros past M) by the butterfly (lane j adds lane
    j ^ off for off = 16 .. 1; lane 0's result), the chunks in order."""
    f, m, c = x.shape
    x = np.concatenate([x, np.zeros((f, -m % 32, c), f32)], 1)
    lanes = np.arange(32)
    total = np.zeros((f, c), f32)
    for base in range(0, x.shape[1], 32):
        v = x[:, base:base + 32]
        for off in (16, 8, 4, 2, 1):
            v = v + v[:, lanes ^ off]
        total = total + v[:, 0]
    return total


def oracle_model(st, spec, teach, windows, task_id, pair_idx, n_zoom=3):
    """The kernel's algorithm in numpy, vectorized over cameras and
    windows: draws by the uint32 hash, one channel bit per (object,
    window), counts and areas walked in object order, moments of the
    centers d = c - o about the window's center o summed by the warp's
    butterfly over chunks of 32 objects (`warp_tree_sum`), the variance
    double-rounded, the accuracy over the camera's windows."""
    a0, a1, pmax, fl = (np.asarray(x, np.float32) for x in teach[:4])
    cls = np.asarray(teach.cls, np.int64)
    salt = np.asarray(teach.salt, np.int64)
    f, m = st["oid"].shape
    p = a0.shape[0]
    oid, cam, t = st["oid"], st["cam_salt"], st["t"]
    bucket = t // spec.flicker_bucket
    keep = hash01_np(oid, t[:, None], cam[:, None], 0x4D155) >= f32(
        spec.miss_rate)                                      # [F, M]
    u1 = hash01_np(oid[:, None], salt[None, :, None], cam[:, None, None],
                   0xBA5E)
    u2 = hash01_np(oid[:, None], salt[None, :, None], cam[:, None, None],
                   bucket[:, None, None])
    flk = fl[None, :, None]
    draw = (((f32(1) - flk) * u1 + flk * u2)
            / np.maximum(pmax, f32(1e-6))[None, :, None])    # [F, P, M]
    kinds = np.where(np.arange(m) < spec.max_people, 0, 1)
    live = st["enabled"][:, None, :] & (cls[:, None] == kinds)[None]
    draws = np.concatenate([np.where(live & keep[:, None], draw, f32(2)),
                            np.where(live, draw, f32(2))], 1)  # [F, 2P, M]
    a0_2, span = np.tile(a0, 2), np.tile(np.maximum(a1 - a0, f32(1e-6)), 2)

    win = np.asarray(windows, np.float32)
    x0, y0, fw, fh = (win[None, :, i] for i in range(4))      # [1, C]
    o_x, o_y = x0 + fw * f32(0.5), y0 + fh * f32(0.5)          # [1, C]
    c = win.shape[0]
    cnt = np.zeros((f, 2 * p, c), f32)
    area = np.zeros((f, 2 * p, c), f32)
    terms = []                                 # per object: moment terms
    ext = np.zeros((f, c), f32)
    half = f32(2)
    for j in range(m):                         # objects in index order
        ox, oy = st["pos"][:, j, :1], st["pos"][:, j, 1:]     # [F, 1]
        ow, oh = st["size"][:, j, :1], st["size"][:, j, 1:]
        ix0 = np.maximum(ox - ow / half, x0)
        ix1 = np.minimum(ox + ow / half, x0 + fw)
        iy0 = np.maximum(oy - oh / half, y0)
        iy1 = np.minimum(oy + oh / half, y0 + fh)
        iw = np.maximum(ix1 - ix0, f32(0))
        ih = np.maximum(iy1 - iy0, f32(0))
        vis = (iw * ih) / np.maximum(ow * oh, f32(1e-9)) >= f32(
            spec.min_visible)
        nw, nh = iw / fw, ih / fh
        app = np.maximum(nw, nh)
        ramp = np.clip((app[:, None] - a0_2[None, :, None])
                       / span[None, :, None], f32(0), f32(1))
        det = ((draws[:, :, j, None] < ramp) & vis[:, None]).astype(f32)
        cnt += det
        area += det * (nw * nh)[:, None]
        mult = det[:, :p].sum(1, dtype=f32)     # integers: exact
        dx, dy = (ix0 + ix1) / half - o_x, (iy0 + iy1) / half - o_y
        terms.append((mult, mult * dx, mult * dy,
                      mult * (dx * dx + dy * dy)))
        ext = np.maximum(ext, np.where(mult > 0, np.maximum(iw, ih),
                                       f32(0)))
    nbox, sx, sy, s2 = (warp_tree_sum(np.stack(x, 1)) for x in zip(*terms))
    nb = np.maximum(nbox, f32(1e-9))
    ex, ey = sx / nb, sy / nb
    has = nbox > 0
    var = fma_f32_np(-ey, ey, fma_f32_np(-ex, ex, s2 / nb))
    spread = np.where(has, np.sqrt(np.maximum(var, f32(0))), f32(0))
    centroid = np.where(has[..., None], np.stack([o_x + ex, o_y + ey], -1),
                        f32(0))
    cnt_t = cnt[:, p:]
    mx = cnt_t.max(-1)                                       # [F, P]
    acc = None
    for q in range(len(pair_idx)):
        cq, mq = cnt_t[:, pair_idx[q]], mx[:, pair_idx[q], None]
        if task_id[q] == 0:
            a = np.where(mq > 0, (cq > 0).astype(f32), f32(1))
        else:
            a = np.where(mq > 0, cq / np.maximum(mq, f32(1e-9)), f32(1))
        acc = a if acc is None else acc + a
    n = c // n_zoom
    def to_nz(x):           # [F, P, C] -> [F, N, Z, P]
        return x[:, :p].transpose(0, 2, 1).reshape(f, n, n_zoom, p)

    return dict(counts=to_nz(cnt), areas=to_nz(area),
                centroid=centroid.reshape(f, n, n_zoom, 2),
                spread=spread.reshape(f, n, n_zoom),
                extent=ext.reshape(f, n, n_zoom),
                nbox=nbox.astype(np.int64).reshape(f, n, n_zoom),
                acc_true=(acc * (f32(1) / f32(len(pair_idx)))).reshape(
                    f, n, n_zoom))


def assert_obs_close(got: dict, want: dict, *, exact_floats=False):
    """The oracle tolerances: counts, nbox and acc_true exact; areas,
    centroid and extent 1e-5; spread as a variance 1e-2 deg^2."""
    for name in ("counts", "nbox", "acc_true"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    tol = 0 if exact_floats else 1e-5
    for name in ("areas", "centroid", "extent"):
        np.testing.assert_allclose(got[name], want[name], rtol=tol,
                                   atol=tol, err_msg=name)
    np.testing.assert_allclose(got["spread"] ** 2, want["spread"] ** 2,
                               atol=1e-2, rtol=1e-5)


def np_obs(obs) -> dict:
    return {k: np.asarray(v) for k, v in obs._asdict().items()}


# ---------------------------------------------------------------------------
# the plain version against the JAX package
# ---------------------------------------------------------------------------

# (name, F, people, cars, pairs, miss_rate, enabled fraction)
CASES = [
    ("default", 5, 14, 8, 4, 0.12, 0.85),
    ("miss0", 4, 14, 8, 4, 0.0, 0.85),
    ("miss1", 4, 14, 8, 4, 1.0, 0.85),
    ("all_disabled", 3, 14, 8, 4, 0.12, 0.0),
    ("binary_1pair", 4, 14, 8, 1, 0.12, 0.9),
    ("8pairs", 3, 14, 8, 8, 0.12, 0.9),
    ("M128", 2, 100, 28, 4, 0.12, 0.85),
    ("M160", 2, 100, 60, 4, 0.12, 0.85),      # 5 chunks of 32 objects
]


def specs(people, cars, miss_rate):
    kw = dict(max_people=people, max_cars=cars, miss_rate=miss_rate)
    return jscene.SceneSpec(**kw), tscene.SceneSpec(**kw)


def jax_observe(st, jspec, n_pairs):
    """The JAX package's observe_all_cells on the numpy state."""
    sw = j_workload_spec(Workload(tuple(
        Query(m, o, task) for m, o, task in ORACLE_WORKLOADS[n_pairs])))
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
    return jobs.observe_all_cells(
        jspec, jobs.teacher_arrays(sw.pairs), params, state,
        jnp.asarray(st["t"], jnp.int32), jobs.grid_windows(DEFAULT_GRID),
        task_id=sw.task_id, pair_idx=sw.pair_idx,
        cam_salt=jnp.asarray(st["cam_salt"].astype(np.uint32)))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_matches_jax(case):
    name, f, people, cars, n_pairs, miss, en = case
    st = oracle_state(f, people, cars, seed=len(name) + f, enabled_p=en)
    jspec, tspec = specs(people, cars, miss)
    want = np_obs(jax_observe(st, jspec, n_pairs))
    args, kw = oracle_args(st, tspec, n_pairs)
    got = np_obs(tobs.observe_all_cells(*args, **kw))
    assert_obs_close(got, want)
    counts = got["counts"].sum()
    if name == "all_disabled":
        assert counts == 0 and (got["acc_true"] == 1.0).all()
    elif name == "miss1":             # every student draw misses
        assert counts == 0 and got["acc_true"].min() < 1.0
    else:
        assert counts > 0


def test_plain_flicker_bucket_boundary():
    """One state at frames 2 and 3 (flicker buckets 0 and 1 at the
    default bucket of 3): the draws change, and both packages agree on
    each side of the boundary."""
    st = oracle_state(4, 14, 8, seed=7)
    jspec, tspec = specs(14, 8, 0.12)
    outs = []
    for frame in (2, 3):
        st["t"] = np.full(4, frame, np.int64)
        args, kw = oracle_args(st, tspec, 4)
        got = np_obs(tobs.observe_all_cells(*args, **kw))
        assert_obs_close(got, np_obs(jax_observe(st, jspec, 4)))
        outs.append(got)
    assert not np.array_equal(outs[0]["counts"], outs[1]["counts"])


def test_observe_all_cells_goes_through_oracle_pass(monkeypatch):
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0])
        return orc.oracle_pass(*args, **kwargs)

    monkeypatch.setattr(tobs, "oracle_pass", spy)
    spec = tscene.SceneSpec()
    args, kw = oracle_args(oracle_state(2, 14, 8, seed=1), spec, 4)
    out = tobs.observe_all_cells(*args, **kw)
    assert calls == [spec]
    # on CPU tensors the wrapper is the plain version
    assert_obs_close(np_obs(out), np_obs(orc.oracle_pass_plain(*args, **kw)),
                     exact_floats=True)


# ---------------------------------------------------------------------------
# numpy models of the kernel against the plain version
# ---------------------------------------------------------------------------

def test_hash_uint32_model_equals_hash01():
    rng = np.random.default_rng(0)
    a = rng.integers(-2 ** 40, 2 ** 40, (6, 1, 9))
    b = rng.integers(0, 2 ** 32, (1, 5, 1), dtype=np.uint64).astype(np.int64)
    c = rng.integers(-2 ** 31, 2 ** 31, (6, 5, 9))
    want = tobs.hash01(torch.as_tensor(a), torch.as_tensor(b),
                       torch.as_tensor(c), 0xBA5E).numpy()
    np.testing.assert_array_equal(hash01_np(a, b, c, 0xBA5E), want)
    edge = np.array([0, 1, 0xFFFFFFFF, 2 ** 32, 2 ** 32 + 7, -1, -2,
                     -2 ** 31, 2 ** 31, 2 ** 40 + 5], np.int64)
    x, y = np.meshgrid(edge, edge)
    want = tobs.hash01(torch.as_tensor(x), torch.as_tensor(y), 0x4D155,
                       torch.as_tensor(y)).numpy()
    np.testing.assert_array_equal(hash01_np(x, y, 0x4D155, y), want)
    # the draws are exact multiples of 2^-32 below 1 (a uint32 rounded to
    # float32 may reach 2^32: then 1.0, as on every side)
    assert want.min() >= 0.0 and want.max() <= 1.0


def test_fma_f32_model_equals_numerics():
    """The kernel's __dmul_rn/__dadd_rn/__double2float_rn rounding of
    numerics.fma_f32, on spreads that cancel (c ~ a * b) and on random
    ones; a float32 product rounded first differs on the cancelling
    ones, which is why the product stays exact."""
    rng = np.random.default_rng(1)
    a = rng.uniform(-100, 100, 4096).astype(np.float32)
    b = a * (1 + rng.normal(0, 1e-6, 4096)).astype(np.float32)
    c = (-(a.astype(np.float64) * b)
         * (1 + rng.normal(0, 1e-7, 4096))).astype(np.float32)
    c[::2] = rng.uniform(-1e4, 1e4, 2048).astype(np.float32)
    want = fma_f32(torch.as_tensor(a), torch.as_tensor(b),
                   torch.as_tensor(c)).numpy()
    np.testing.assert_array_equal(fma_f32_np(a, b, c), want)
    rounded_first = (a * b).astype(np.float32) + c
    assert (rounded_first != want).any()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernel_model_matches_plain(case):
    """The kernel's algorithm (its sum orders) equals the plain
    version on counts, box counts and accuracy, and within the oracle
    tolerances on the float sums."""
    name, f, people, cars, n_pairs, miss, en = case
    st = oracle_state(f, people, cars, seed=len(name) + 2 * f, enabled_p=en)
    spec = tscene.SceneSpec(max_people=people, max_cars=cars,
                            miss_rate=miss)
    args, kw = oracle_args(st, spec, n_pairs)
    want = np_obs(orc.oracle_pass_plain(*args, **kw))
    got = oracle_model(st, spec, args[1], window_arrays(DEFAULT_GRID),
                       kw["task_id"], kw["pair_idx"])
    assert_obs_close(got, want)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_spreads_near_float64(case):
    """The plain version's and the kernel model's variances (spread^2)
    lie within 1e-2 of the float64 sum of the same per-object terms, the
    reference the card tests hold both sides to; the kernel model's
    moments about the window's center within 1e-3 (the plain version's
    absolute moments cancel: E[c^2] reaches ~3e4 deg^2)."""
    name, f, people, cars, n_pairs, miss, en = case
    st = oracle_state(f, people, cars, seed=len(name) + 3 * f, enabled_p=en)
    spec = tscene.SceneSpec(max_people=people, max_cars=cars,
                            miss_rate=miss)
    args, kw = oracle_args(st, spec, n_pairs)
    var64 = np.maximum(oracle_variance_f64(args, kw).numpy(), 0.0)
    plain = np_obs(orc.oracle_pass_plain(*args, **kw))["spread"]
    model = oracle_model(st, spec, args[1], window_arrays(DEFAULT_GRID),
                         kw["task_id"], kw["pair_idx"])["spread"]
    for spread, tol in ((plain, 1e-2), (model, 1e-3)):
        np.testing.assert_allclose(spread.astype(np.float64) ** 2, var64,
                                   rtol=0, atol=tol)


def test_wrapper_raises_off_cpu_without_kernel():
    """No fallback: a device that is neither the CPU nor a CUDA card
    raises instead of running the plain version."""
    args, kw = oracle_args(oracle_state(1, 14, 8, seed=0),
                           tscene.SceneSpec(), 4)
    state = args[3]._replace(oid=args[3].oid.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        orc.oracle_pass(*args[:3], state, *args[4:], **kw)
