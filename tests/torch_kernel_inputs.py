"""Seeded numpy inputs for the port's kernel tests, shaped like the main
path's (22 object slots, the default 5x5 grid's 75 windows), and fleet
states for the shape-search kernels on grids of 25 to 200 cells.
Imports numpy and the port only, so the card-only tests run where JAX is
not installed."""
import numpy as np
import torch

from repro_torch.core import DEFAULT_GRID, OrientationGrid
from repro_torch.kernels.cell_rasterize.ops import window_arrays
from repro_torch.kernels.neighbor_score.ops import geometry_arrays
from repro_torch.models.layers import DENSE_MIN_MACS, DENSE_MIN_ROWS

M = 22          # 14 people + 8 cars
GEO = geometry_arrays(DEFAULT_GRID)
# the default 5x5 grid, bench_deepdive's pan step 15 (10x5), the largest
# grid of two-word cell sets (16x8) and the 7.5-degree grid (20x10, four
# words)
SEARCH_GRIDS = {25: DEFAULT_GRID, 50: OrientationGrid(pan_step=15.0),
                128: OrientationGrid(pan_step=9.375, tilt_step=9.375),
                200: OrientationGrid(pan_step=7.5, tilt_step=7.5)}


def t(x):
    """numpy/jax array -> CPU tensor (ints as int64)."""
    a = np.asarray(x)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.as_tensor(a.copy())


def neighbor_inputs(b, seed):
    rng = np.random.default_rng(seed)
    n = DEFAULT_GRID.n_cells
    shape = rng.random((b, n)) < 0.35
    has = rng.random((b, n)) < 0.7
    cent = (np.asarray(DEFAULT_GRID.centers, np.float32)[None]
            + rng.normal(0, 8, (b, n, 2))).astype(np.float32)
    head = rng.integers(0, n, b)
    return shape, has, cent, head


def rasterize_inputs(f, p, seed, m=M):
    rng = np.random.default_rng(seed)
    ox = rng.uniform(0, 150, (f, m)).astype(np.float32)
    oy = rng.uniform(0, 75, (f, m)).astype(np.float32)
    ow = rng.uniform(1.0, 9.0, (f, m)).astype(np.float32)
    oh = rng.uniform(1.0, 9.0, (f, m)).astype(np.float32)
    ow[:, -2:] = oh[:, -2:] = 0.0                  # disabled slots
    draw = rng.uniform(0, 1.2, (f, p, m)).astype(np.float32)
    draw[rng.random((f, p, m)) < 0.2] = 2.0
    a0 = rng.uniform(0.03, 0.1, p).astype(np.float32)
    a1 = (a0 + rng.uniform(0.05, 0.2, p)).astype(np.float32)
    win = window_arrays(DEFAULT_GRID)
    return ox, oy, ow, oh, draw, a0, a1, win


def patchify_inputs(f, k, d, seed, shared, m=M):
    """M object slots (14 people of the default 22, else 3/5 people)."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([0, 0], [150, 75], (f, m, 2)).astype(np.float32)
    size = rng.uniform(1.5, 9.0, (f, m, 2)).astype(np.float32)
    size[:, -2:] = 0.0                             # disabled slots
    kind = (np.arange(m) >= (14 if m == M else 3 * m // 5)).astype(np.int32)
    oid = rng.integers(0, 4000, (f, m)).astype(np.int32)
    wins_all = window_arrays(DEFAULT_GRID)
    if shared:
        wins = wins_all[:k]
    else:
        wins = wins_all[np.stack([rng.choice(wins_all.shape[0], k,
                                             replace=False)
                                  for _ in range(f)])]
    pe = {"w": (rng.normal(0, 0.05, (16, 16, 3, d))).astype(np.float32),
          "b": rng.normal(0, 0.01, d).astype(np.float32)}
    noise = (0.05 * rng.normal(0, 1, (f, 64, 64, 3))).astype(np.float32)
    return pos, size, kind, oid, wins, pe, noise


def _blob(rng, grid, size):
    """A random 8-connected shape of `size` cells (grown cell by cell)."""
    n = grid.n_cells
    nbr = np.asarray(grid.neighbor_mask)
    mask = np.zeros(n, bool)
    mask[rng.integers(n)] = True
    while mask.sum() < size:
        frontier = np.flatnonzero(nbr[mask].any(0) & ~mask)
        mask[rng.choice(frontier)] = True
    return mask


def _shapes(rng, grid, f):
    """F shapes of every kind, in turn from a seeded offset: empty,
    1-member, 8-connected blobs (whose induced MST is often cut in pieces:
    the walk's stitch), scattered (not 8-connected), full."""
    n = grid.n_cells
    out = np.zeros((f, n), bool)
    off = int(rng.integers(12))
    for i in range(f):
        kind = (i + off) % 12
        if kind in (0, 6):
            out[i] = np.arange(n) == rng.integers(n)
        elif kind in (1, 2, 3, 7, 8, 9):
            out[i] = _blob(rng, grid, rng.integers(2, n // 2 + 2))
        elif kind in (4, 10):
            out[i] = rng.random(n) < rng.uniform(0.1, 0.5)
        elif kind == 5:
            out[i] = True
    return out                                   # kind 11: empty


def _labels(rng, f, n):
    """Ties on purpose: half the cameras quantized to quarters with many
    exact zeros, a quarter at one constant value, the rest continuous."""
    lab = rng.uniform(0, 1, (f, n)).astype(np.float32)
    q = (rng.integers(0, 4, (f, n)) / 4).astype(np.float32)
    q[rng.random((f, n)) < 0.4] = 0.0
    kind = (np.arange(f) + rng.integers(4)) % 4
    lab[kind < 2] = q[kind < 2]
    lab[kind == 2] = np.float32(0.25)
    return lab


def search_state(grid, f, seed):
    """(shape, labels, has_boxes, centroids) of F cameras: numpy, seeded.
    Every seventh camera has no boxes (every score the neutral 1.0)."""
    n = grid.n_cells
    rng = np.random.default_rng(seed)
    shape = _shapes(rng, grid, f)
    has = rng.random((f, n)) < 0.6
    has[::7] = False
    cent = (np.asarray(grid.centers, np.float32)[None]
            + rng.normal(0, 6, (f, n, 2))).astype(np.float32)
    return shape, _labels(rng, f, n), has, cent


# the oracle pass: workloads of 1, 4 and 8 teacher pairs, each query
# list mixing binary and count-like tasks (the 8-pair one names a pair
# twice, so Q > P)
ORACLE_WORKLOADS = {
    1: (("ssd", "car", "binary"),),
    4: (("yolov4", "person", "count"), ("ssd", "car", "detect"),
        ("frcnn", "person", "binary"),
        ("tiny-yolov4", "person", "agg_count")),
    8: tuple((model, obj, task) for (model, obj), task in zip(
        [(m, o) for m in ("frcnn", "yolov4", "ssd", "tiny-yolov4")
         for o in ("person", "car")],
        ("binary", "count", "detect", "agg_count") * 2))
    + (("ssd", "person", "binary"),),
}


def oracle_workload(n_pairs):
    """(pairs, task_id, pair_idx) of the port's WorkloadSpec."""
    from repro_torch.core.rank import Query, Workload
    from repro_torch.fleet.state import workload_spec
    wl = workload_spec(Workload(tuple(
        Query(m, o, task) for m, o, task in ORACLE_WORKLOADS[n_pairs])))
    return wl.pairs, wl.task_id, wl.pair_idx


def oracle_state(f, n_people, n_cars, seed, *, enabled_p=0.85):
    """A seeded fleet state for the oracle pass (numpy): objects over the
    whole extent, from specks below every teacher's floor to boxes wider
    than a zoomed window; ids, camera salts (full uint32 range) and
    frame clocks that cross flicker buckets."""
    rng = np.random.default_rng(seed)
    m = n_people + n_cars
    pos = rng.uniform([0, 0], [150, 75], (f, m, 2)).astype(np.float32)
    size = rng.uniform(2.5, 9.0, (f, m, 2)).astype(np.float32)
    size[rng.random((f, m)) < 0.1] *= np.float32(0.1)
    size[rng.random((f, m)) < 0.05] *= np.float32(4.0)
    return dict(
        pos=pos, size=size,
        oid=rng.integers(0, 2 ** 31 - 1, (f, m)).astype(np.int64),
        enabled=rng.random((f, m)) < enabled_p,
        cam_salt=rng.integers(0, 2 ** 32, f, dtype=np.uint64).astype(
            np.int64),
        t=rng.integers(0, 40, f).astype(np.int64))


def oracle_args(st, spec, n_pairs, device="cpu"):
    """The port's observe_all_cells arguments for a numpy state:
    (spec, teach, params, state, t, windows) and the keywords."""
    from repro_torch.scene import observe as tobs
    from repro_torch.scene import scene as tscene
    pairs, task_id, pair_idx = oracle_workload(n_pairs)
    f, m = st["oid"].shape

    def dv(x):
        return t(x).to(device)

    zeros2 = torch.zeros((f, m, 2), device=device)
    state = tscene.SceneState(
        pos=dv(st["pos"]), vel=zeros2, size=dv(st["size"]),
        waypoint=zeros2, oid=dv(st["oid"]),
        next_id=torch.full((f,), m, dtype=torch.int64, device=device))
    zf = torch.zeros(f, device=device)
    params = tscene.SceneFleetParams(
        person_speed=zf, car_speed=zf, churn=zf,
        poi=torch.zeros((f, spec.n_poi, 2), device=device),
        enabled=torch.as_tensor(st["enabled"], device=device))
    teach = tobs.teacher_arrays(pairs, device=device)
    windows = tobs.grid_windows(DEFAULT_GRID, device=device)
    return ((spec, teach, params, state, dv(st["t"]), windows),
            dict(task_id=task_id, pair_idx=pair_idx,
                 cam_salt=dv(st["cam_salt"])))


def oracle_variance_f64(args, kw):
    """The variance E[c^2] - |E[c]|^2 of every window, [F, N, Z] float64:
    the oracle pass's own float32 per-object terms (its detections and
    clipped centers, from the plain version's pieces) summed in float64,
    0 where no box is counted. The reference the float32 spreads of the
    kernel and of the plain version are measured against."""
    from repro_torch.kernels.cell_rasterize.ops import window_geometry
    from repro_torch.kernels.oracle_pass.ops import oracle_draws
    spec, teach, params, state, t_, windows = args
    f = state.oid.shape[0]
    p = teach.a0.shape[0]
    detf, _, ccx, ccy, _ = window_geometry(
        state.pos[..., 0].contiguous(), state.pos[..., 1].contiguous(),
        state.size[..., 0].contiguous(), state.size[..., 1].contiguous(),
        oracle_draws(spec, teach, params, state, t_, kw.get("cam_salt")),
        teach.a0.repeat(2), teach.a1.repeat(2), windows,
        min_visible=spec.min_visible)
    mult = detf[:, :p].sum(1).double()                 # [F, M, C]
    cx, cy = ccx.double(), ccy.double()
    nb = mult.sum(1)
    nbc = nb.clamp(min=1e-9)
    ex, ey = (mult * cx).sum(1) / nbc, (mult * cy).sum(1) / nbc
    var = (mult * (cx * cx + cy * cy)).sum(1) / nbc - ex * ex - ey * ey
    return torch.where(nb > 0, var, 0.0).reshape(f, -1, kw.get("n_zoom", 3))


def spread_errors(got, want, var64):
    """(max |got var - var64|, max |want var - var64|, max |got var - want
    var|, windows where |got var - want var| > 1e-2), each variance read
    as spread^2 in float64 against var64 clamped at 0 as the spread is."""
    g = got.spread.double() ** 2
    w = want.spread.double() ** 2
    v = var64.clamp(min=0.0)
    return (float((g - v).abs().max()), float((w - v).abs().max()),
            float((g - w).abs().max()), int(((g - w).abs() > 1e-2).sum()))


def clone_tree(x):
    """Tensors in nested tuples (NamedTuples keep their type) and dicts,
    cloned: what a recorded call gave, kept past the caller's in-place
    updates."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):
        vals = [clone_tree(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    return x


# scene/prng.py's public draws: one threefry launch each on the card
DRAWS = ("fold_in", "split", "random_bits", "uniform", "randint", "normal")


def count_card_draws(monkeypatch) -> list:
    """Wrap scene/prng.py's public draws (every caller reaches them as
    prng.<name>) to count the calls on a CUDA key -> a one-element list
    holding that count: the threefry launches a run must make."""
    from repro_torch.scene import prng
    n = [0]
    for name in DRAWS:
        def draw(key, *args, _fn=getattr(prng, name), **kwargs):
            n[0] += prng._on_card(key)
            return _fn(key, *args, **kwargs)
        monkeypatch.setattr(prng, name, draw)
    return n


def vit_dense_launches(cfg, batch: int) -> int:
    """dense launches of one float32 ViT forward without gradients over
    `batch` images of cfg: each layer's q, k, v, o (d x d), MLP up (d x
    d_ff) and down whose rows (CLS and patch tokens) and multiply-adds
    reach DENSE_MIN_ROWS and DENSE_MIN_MACS (layers.linear). The patch
    embed is a product of its own, the detector's heads are convolutions,
    and a classifier head's one row an image stays under DENSE_MIN_ROWS
    at the batches the tests run."""
    rows = batch * (1 + (cfg.img_res // cfg.patch) ** 2)
    d, ff = cfg.d_model, cfg.d_ff
    shapes = ((d, d),) * 4 + ((d, ff), (ff, d))
    return cfg.n_layers * sum(
        rows >= DENSE_MIN_ROWS and rows * k * n >= DENSE_MIN_MACS
        for k, n in shapes)
