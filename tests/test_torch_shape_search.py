"""The shape_search and budget_walk kernels' algorithm, held on the CPU
against their plain versions (the fleet-batch PyTorch loops of
`repro_torch/kernels/shape_search/ops.py`).

The CUDA kernels (`csrc/shape_search.cu`) run one warp per camera with
the camera's cell sets as bit words. `model_shape_search` and
`model_budget_walk` below are that algorithm in Python, one camera at a
time, with Python ints as cell sets:

- stable orders are ranks by counting: the rank of cell i is the number
  of cells j with key_j < key_i, or key_j == key_i and j < i;
- contiguity and components are flood fills to their fixpoint over bit
  rows of the adjacency;
- argmax/argmin keep the first extremum (a sentinel at index 0, then
  strictly better values, in index order);
- every loop stops once its camera is done, within the plain version's
  static bound.

The CUDA code transcribes this model. Neighbor scores are summed over the
members in index order in float32 (csrc/neighbor_score.cuh); the plain
version sums with torch.sum on the CPU. The decisions are compared
exactly, `t` within 1e-6 relative (its hop sum runs in another order;
the hops of these grids are multiples of 7.5 degrees, so it is exact).

Sizes: 64 cameras on the default 25-cell grid; 12 cameras on the
50-cell grid (pan step 15) and 4 on the 200-cell grid (7.5 degrees,
four-word cell sets on the card), where the plain version's [F, N, N]
removal probes grow with N^3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

from repro_torch.fleet import state as tstate  # noqa: E402
from repro_torch.kernels._lib import launch_counts  # noqa: E402
from repro_torch.kernels.shape_search.ops import (  # noqa: E402
    budget_walk_batch,
    budget_walk_plain,
    evolve_shape,
    resize_shape,
    shape_search_batch,
    shape_search_plain,
)
from torch_kernel_inputs import SEARCH_GRIDS, search_state  # noqa: E402

F32 = np.float32
INF = F32(np.inf)
GRIDS = SEARCH_GRIDS
FLEET = {25: 64, 50: 12, 200: 4}


# ---------------------------------------------------------------------------
# the model: one camera, cell sets as Python ints
# ---------------------------------------------------------------------------

def _bits(row) -> int:
    return sum(1 << int(i) for i in np.flatnonzero(row))


def _cells(s: int):
    """The cells of set s, ascending."""
    while s:
        low = s & -s
        yield low.bit_length() - 1
        s ^= low


def _count(s: int) -> int:
    return bin(s).count("1")


class Geometry:
    """A grid's statics as the kernels hold them: bit rows of the
    8-neighbor and MST adjacencies, float32 tables."""

    def __init__(self, statics):
        def a(x):
            return x.numpy()
        self.n = statics.dist.shape[0]
        self.nbr = [_bits(r) for r in a(statics.neighbor8)]
        self.mst = [_bits(r) for r in a(statics.mst_adj)]
        self.dist = a(statics.dist)
        self.d_center = a(statics.d_center)
        self.overlap = a(statics.overlap)
        self.cell_x = a(statics.cell_x)
        self.cell_y = a(statics.cell_y)
        order = a(statics.nbr_order)
        # position of cell c in u's push order
        self.push_pos = np.argsort(order, axis=1)


def stable_order(keys) -> np.ndarray:
    """Cells by ascending key, ties toward the lower id, by counting."""
    k = np.asarray(keys, F32)
    idx = np.arange(k.size)
    before = ((k[None, :] < k[:, None])
              | ((k[None, :] == k[:, None]) & (idx[None, :] < idx[:, None])))
    order = np.empty(k.size, np.int64)
    order[before.sum(1)] = idx
    return order


def flood(mask: int, seed: int, rows) -> int:
    """Cells of `mask` reachable from `seed` over `rows`: the fixpoint,
    taking each reached cell's row once."""
    reach = front = seed & mask
    while front:
        i = (front & -front).bit_length() - 1
        front &= ~(1 << i)
        add = rows[i] & mask & ~reach
        reach |= add
        front |= add
    return reach


def contiguous(mask: int, rows) -> bool:
    return mask == 0 or flood(mask, mask & -mask, rows) == mask


def first_max(values, cells, sentinel=-INF):
    """(value, index) of the first maximum over `cells` (ascending);
    (sentinel, 0) when none beats the sentinel — argmax over a vector
    filled with the sentinel elsewhere."""
    best = (sentinel, 0)
    for i in cells:
        if values[i] > best[0]:
            best = (values[i], i)
    return best


def scores(geo, cand: int, mask: int, has, cx, cy) -> np.ndarray:
    """[n] f32 neighbor scores, filled for the cells of `cand`: the
    overlap-weighted mean of d_center / |cell - centroid| over members
    with boxes, summed in member index order."""
    out = np.full(geo.n, -INF, F32)
    c = np.fromiter(_cells(cand), np.int64)
    if c.size == 0:
        return out
    member = np.array([(mask >> o) & 1 for o in range(geo.n)], bool)
    mh = (member & has).astype(F32)
    w = geo.overlap[c] * mh[None, :]
    dx = geo.cell_x[c][:, None] - cx[None, :]
    dy = geo.cell_y[c][:, None] - cy[None, :]
    d_box = np.sqrt(dx * dx + dy * dy)
    ratio = geo.d_center[c] / np.maximum(d_box, F32(1e-6))
    total = np.cumsum(w * ratio, axis=1, dtype=F32)[:, -1]
    total_w = np.cumsum(w, axis=1, dtype=F32)[:, -1]
    out[c] = np.where(total_w > 0, total / np.maximum(total_w, F32(1e-9)),
                      F32(1.0))
    return out


def best_candidate(geo, cand, mask, has, cx, cy):
    return first_max(scores(geo, cand, mask, has, cx, cy), _cells(cand))


def first_removable(geo, mask: int, labels) -> int:
    member = [(mask >> i) & 1 for i in range(geo.n)]
    order = stable_order(np.where(member, labels, INF))
    ok = [contiguous(mask & ~(1 << int(order[r])), geo.nbr)
          for r in range(_count(mask))]
    return int(order[ok.index(True)]) if any(ok) else int(order[0])


def evolve_multi(geo, cfg, mask, labels, has, cx, cy) -> int:
    n = geo.n
    member = [(mask >> i) & 1 for i in range(n)]
    order = stable_order(np.where(member, -labels, INF))
    m = _count(mask)
    h, t = 0, max(m - 1, 0)
    base = F32(cfg.base_threshold)
    thresh, failed, swaps = base, False, 0
    for _ in range(2 * n + 2 * cfg.max_swaps):
        if h >= t or swaps >= cfg.max_swaps:
            break
        H, T = int(order[min(h, n - 1)]), int(order[min(max(t, 0), n - 1)])
        if not labels[H] / np.maximum(labels[T], F32(1e-9)) > thresh:
            break
        cand = geo.nbr[H] & ~mask
        if not cand:
            if failed:
                break
            h, thresh, failed = h + 1, base, True
            continue
        _, best = best_candidate(geo, cand, mask, has, cx, cy)
        trial = (mask | (1 << best)) & ~(1 << T)
        if contiguous(trial, geo.nbr):
            mask, failed, swaps = trial, False, swaps + 1
            thresh = F32(thresh * F32(cfg.threshold_growth))
        t -= 1
    return mask


def evolve_single(geo, cfg, mask, labels, has, cx, cy) -> int:
    H = (mask & -mask).bit_length() - 1
    lab_h = labels[H]
    base = F32(cfg.base_threshold)
    g_val, g_idx = first_max(labels, range(geo.n))
    jump = g_idx != H and g_val > F32(F32(lab_h * F32(2)) * base)
    cand = geo.nbr[H] & ~mask
    b_val, b_idx = best_candidate(geo, cand, mask, has, cx, cy)
    moving_away = b_val > F32(1.05)
    promising = labels[b_idx] > F32(lab_h * base)
    drift = not jump and cand != 0 and (moving_away or promising)
    if jump or drift:
        mask = (mask & ~(1 << H)) | (1 << (g_idx if jump else b_idx))
    return mask


def model_shape_search(geo, cfg, mask, labels, has, cx, cy, max_cells):
    """One camera: resize_shape(evolve_shape(mask), target=max_cells)."""
    n = geo.n
    m = _count(mask)
    if m == 1:
        mask = evolve_single(geo, cfg, mask, labels, has, cx, cy)
    elif m >= 2:
        mask = evolve_multi(geo, cfg, mask, labels, has, cx, cy)
    target = min(max(int(max_cells), 1), n)
    for _ in range(n):                                   # grow
        if _count(mask) >= target:
            break
        eligible = sum(1 << i for i in _cells(mask) if geo.nbr[i] & ~mask)
        if not eligible:
            break                                        # stuck
        _, H = first_max(labels, _cells(eligible))
        _, best = best_candidate(geo, geo.nbr[H] & ~mask, mask, has, cx, cy)
        mask |= 1 << best
    for _ in range(n - 1):                               # shrink
        if _count(mask) <= target:
            break
        mask &= ~(1 << first_removable(geo, mask, labels))
    return mask


def walk(geo, mask: int, start: int):
    """(preorder cells, hop sum in degrees) of the induced-MST walk."""
    n, dist = geo.n, geo.dist
    start2 = start
    if not (mask >> start) & 1:
        _, start2 = first_max(-dist[start], _cells(mask))   # first argmin
    tree = [geo.mst[i] & mask if (mask >> i) & 1 else 0 for i in range(n)]
    done = flood(mask, 1 << start2, geo.mst)
    for _ in range(n - 1):                   # stitch the components
        rest = mask & ~done
        if not rest:
            break
        best = (INF, 0)                      # first in row-major order
        for u in _cells(done):
            for v in _cells(rest):
                if dist[u, v] < best[0]:
                    best = (dist[u, v], u * n + v)
        u, v = divmod(best[1], n)
        done |= flood(mask, 1 << v, geo.mst) & rest
        tree[u] |= 1 << v
        tree[v] |= 1 << u
    stack, seen, order = [start2] if mask else [], 0, []
    for _ in range(n):                       # preorder DFS
        if not stack:
            break
        u = stack.pop()
        seen |= 1 << u
        order.append(u)
        # the unseen tree neighbors in u's push order
        stack.extend(sorted(_cells(tree[u] & ~seen),
                            key=lambda c: geo.push_pos[u, c]))
    t_deg, prev = F32(0.0), start
    for c in order:
        t_deg, prev = F32(t_deg + dist[prev, c]), c
    return order, t_deg


def model_budget_walk(geo, cfg, mask, start, labels, budget_s, per_cell):
    """One camera: (mask, order, cnt, t) of budget_walk."""
    n = geo.n
    rs, pc, budget = F32(cfg.rotation_speed), F32(per_cell), F32(budget_s)

    def feasible(mask, order, t):
        return (F32(t + F32(pc * F32(len(order)))) <= budget
                or _count(mask) <= 1)

    order, t_deg = walk(geo, mask, start)
    t = F32(t_deg / rs)
    done = feasible(mask, order, t)
    for _ in range(n - 1):
        if done:
            break
        mask &= ~(1 << first_removable(geo, mask, labels))
        o2, td2 = walk(geo, mask, start)
        t2 = F32(td2 / rs)
        if feasible(mask, o2, t2):
            order, t, done = o2, t2, True
    return mask, order, len(order), t


def fleet_state(seed, n, f=None):
    grid = GRIDS[n]
    return (grid, *search_state(grid, f or FLEET[n], seed))


def _tn(x):
    return torch.as_tensor(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,seed", [(25, 0), (25, 1), (50, 2), (200, 9)])
def test_model_shape_search_matches_plain(n, seed):
    grid, shape, labels, has, cent = fleet_state(seed, n)
    f = shape.shape[0]
    rng = np.random.default_rng(seed + 100)
    max_cells = rng.integers(0, n + 3, f)       # 0 and > n: the clamp
    cfg = tstate.fleet_config(grid)
    statics = tstate.fleet_statics(grid)
    geo = Geometry(statics)
    want = shape_search_plain(cfg, statics, _tn(shape), _tn(labels),
                              _tn(cent), _tn(has), _tn(max_cells)).numpy()
    for i in range(f):
        got = model_shape_search(geo, cfg, _bits(shape[i]), labels[i],
                                 has[i], cent[i, :, 0], cent[i, :, 1],
                                 max_cells[i])
        assert got == _bits(want[i]), f"camera {i}"
    # the states reach every branch: swaps, growth and shrinking happen
    assert (want != shape).any(1).sum() > f // 4


@pytest.mark.parametrize("n,seed,per_cell", [(25, 3, 0.0), (25, 4, 0.004),
                                             (50, 5, 0.0), (200, 13, 0.0)])
def test_model_budget_walk_matches_plain(n, seed, per_cell):
    grid, shape, labels, _, _ = fleet_state(seed, n)
    f = shape.shape[0]
    rng = np.random.default_rng(seed + 200)
    start = rng.integers(0, n, f)
    # budgets that fit nothing, everything, and in between
    budget = rng.uniform(0.0, 0.6, f).astype(F32)
    budget[::5] = 0.0
    budget[1::5] = 1e3
    cfg = tstate.fleet_config(grid)
    statics = tstate.fleet_statics(grid)
    geo = Geometry(statics)
    mask, order, cnt, t = budget_walk_plain(
        cfg, statics, _tn(shape), _tn(start), _tn(labels), _tn(budget),
        per_cell)
    shrunk = 0
    for i in range(f):
        m, o, c, ti = model_budget_walk(geo, cfg, _bits(shape[i]),
                                        int(start[i]), labels[i], budget[i],
                                        per_cell)
        assert m == _bits(mask[i].numpy()), f"camera {i}"
        assert o + [-1] * (n - c) == order[i].tolist(), f"camera {i}"
        assert c == int(cnt[i])
        np.testing.assert_allclose(ti, float(t[i]), rtol=1e-6, atol=0)
        shrunk += m != _bits(shape[i])
    assert shrunk > f // 4


def test_model_walk_stitches_cut_trees():
    """Shapes that are 8-connected but whose induced MST falls apart:
    the walk stitches the pieces and visits every cell once."""
    grid, shape, labels, _, _ = fleet_state(6, 25)
    statics = tstate.fleet_statics(grid)
    geo = Geometry(statics)
    cut = 0
    for i in range(shape.shape[0]):
        mask = _bits(shape[i])
        if not mask:
            continue
        first = (mask & -mask).bit_length() - 1
        cut += flood(mask, 1 << first, geo.mst) != mask
        order, _ = walk(geo, mask, first)
        assert sorted(order) == list(_cells(mask))
    assert cut > 0


def test_wrappers_on_cpu_are_the_plain_loops():
    """On CPU tensors the wrappers return exactly what fleet_step's
    inline loops did (evolve_shape -> resize_shape, then the budget
    shrink) and launch nothing."""
    n = 25
    grid, shape, labels, has, cent = fleet_state(7, n, f=16)
    rng = np.random.default_rng(8)
    cfg = tstate.fleet_config(grid)
    statics = tstate.fleet_statics(grid)
    args = [_tn(x) for x in (shape, labels, cent, has)]
    max_cells = _tn(rng.integers(1, 9, 16))
    before = launch_counts()
    got = shape_search_batch(cfg, statics, *args, max_cells)
    evolved = evolve_shape(cfg, statics, *args)
    want = resize_shape(cfg, statics, evolved, *args[1:], max_cells)
    assert torch.equal(got, want)
    start = _tn(rng.integers(0, n, 16))
    budget = _tn(rng.uniform(0, 0.3, 16).astype(F32))
    got = budget_walk_batch(cfg, statics, got, start, args[1], budget, 0.0)
    want = budget_walk_plain(cfg, statics, want, start, args[1], budget, 0.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert launch_counts() == before
