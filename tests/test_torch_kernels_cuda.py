"""The port's CUDA kernels against their plain PyTorch versions, on
the card (`requires_cuda`: skipped without one; CUDA kernels have no CPU
mode). Imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances: counts exact; neighbor scores, areas and moments 1e-5
(float32 sums in another order); the oracle pass's counts, box counts
and accuracy exact, its areas, centroids and extents 1e-5 and its
spread as a variance within 1e-2 of the plain version's and of a
float64 sum, the kernel's within 1e-3 of the latter (see
assert_oracle_equal); patch tokens 1e-4 absolute on values of order 1
(the token product in split TF32 on the tensor cores vs torch.matmul);
attention 3e-5 in float32 (split-TF32 products, online softmax, sums in
another order) and 2e-2 in bfloat16; IoU bit-equal (max_abs_err 0);
NMS masks, matches, changed tiles and int8 residuals exact;
rmsnorm 1e-5; shape_search and budget_walk decisions (masks, walk
orders, counts) exact and the walk time 1e-6 relative (its hop sum in
another order).

At the main path's full width (madeye-approx, 64 cameras, 8 steps,
shortlist_k=18, frozen and with head-only distillation; full-network
distillation at 3 steps) run_fleet launches each main-path kernel once
a step, threefry once for each of the 19 draws a step, dense once for
each of the ViT's 36 linears and flash_attention once for each of its 6
layers (neither in full mode, whose forward runs under vmap), and
nothing else;
and every oracle_pass, shape_search and budget_walk call of the episode
gives what its plain version gives on the same inputs.
`tools/kernel_table.py` times the kernels at the cells' shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import DEFAULT_GRID, OrientationGrid  # noqa: E402
from repro_torch.fleet import api as api_module  # noqa: E402
from repro_torch.fleet import runner as runner_module  # noqa: E402
from repro_torch.fleet import state as tstate  # noqa: E402
from repro_torch.fleet import step as step_module  # noqa: E402
from repro_torch.fleet.api import FleetRunSpec, run_fleet  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.box_iou.ops import (  # noqa: E402
    box_iou,
    box_iou_plain,
    match_boxes,
    nms_mask,
)
from repro_torch.kernels.cell_rasterize.ops import (  # noqa: E402
    cell_rasterize,
    cell_rasterize_plain,
    window_arrays,
)
from repro_torch.kernels.crop_patchify.ops import (  # noqa: E402
    crop_patchify_batch,
    crop_patchify_plain,
)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
    resident_keys,
)
from repro_torch.kernels.frame_delta.ops import (  # noqa: E402
    frame_delta,
    frame_delta_plain,
)
from repro_torch.kernels.neighbor_score.ops import (  # noqa: E402
    neighbor_score_batch,
    neighbor_score_plain,
)
from repro_torch.kernels.oracle_pass.ops import (  # noqa: E402
    oracle_pass,
    oracle_pass_plain,
)
from repro_torch.kernels.rmsnorm.ops import (  # noqa: E402
    rmsnorm,
    rmsnorm_plain,
)
from repro_torch.kernels.shape_search.ops import (  # noqa: E402
    budget_walk_batch,
    budget_walk_plain,
    shape_search_batch,
    shape_search_plain,
)
from repro_torch.learn.spec import DistillSpec  # noqa: E402
from repro_torch.models import detector as det  # noqa: E402
from repro_torch.models.layers import full_float32  # noqa: E402
from repro_torch.scene import observe as observe_module  # noqa: E402
from repro_torch.scene.render import (  # noqa: E402
    object_colors,
    render_background,
)
from repro_torch.scene.scene import SceneSpec  # noqa: E402
from torch_kernel_inputs import (  # noqa: E402
    GEO,
    SEARCH_GRIDS,
    clone_tree,
    count_card_draws,
    neighbor_inputs,
    oracle_args,
    oracle_state,
    oracle_variance_f64,
    patchify_inputs,
    rasterize_inputs,
    search_state,
    spread_errors,
    t,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
def test_neighbor_score_kernel_on_card(cuda):
    shape, has, cent, _ = neighbor_inputs(64, 5)
    mh = torch.as_tensor(shape & has, dtype=torch.float32, device=cuda)
    args = (mh, t(cent[..., 0]).to(cuda), t(cent[..., 1]).to(cuda),
            *(t(GEO[k]).to(cuda) for k in ("d_center", "overlap", "cell_x",
                                           "cell_y")))
    _lib.reset_launch_counts()
    got = neighbor_score_batch(*args)
    assert _lib.launch_counts()["neighbor_score"] == 1
    torch.testing.assert_close(got, neighbor_score_plain(*args), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.requires_cuda
def test_cell_rasterize_kernel_on_card(cuda):
    args = [t(x).to(cuda) for x in rasterize_inputs(64, 8, 6)]
    got = cell_rasterize(*args, n_moment=4)
    want = cell_rasterize_plain(*args, n_moment=4)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# (F, M, P): one camera, the main path's fleet and a large one; the
# scene's 22 object slots, 128 and the kernel's 256; 2, 8 and 16 channels
RASTER_CASES = [(f, m, p) for f in (1, 64, 1024) for m in (22, 128)
                for p in (2, 8, 16)] + [(1, 256, 16), (64, 256, 8)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f,m,p", RASTER_CASES,
                         ids=[f"F{f}-M{m}-P{p}" for f, m, p in RASTER_CASES])
def test_cell_rasterize_shapes_on_card(cuda, f, m, p):
    args = [t(x).to(cuda) for x in rasterize_inputs(f, p, f + m + p, m=m)]
    _lib.reset_launch_counts()
    got = cell_rasterize(*args, n_moment=p // 2)
    assert _lib.launch_counts()["cell_rasterize"] == 1
    want = cell_rasterize_plain(*args, n_moment=p // 2)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def assert_oracle_equal(got, want, var64=None):
    """counts, nbox and acc_true exact; areas, centroid and extent 1e-5;
    the spread as a variance (spread^2) within 1e-2 of the plain
    version's and, given `var64`, of the float64 sum of the same
    per-object terms, at every slot count. The plain version's variance E[c^2]
    - |E[c]|^2 cancels (E[c^2] reaches ~3e4 deg^2, one float32 ulp of it
    ~2e-3: up to 8.5e-3 off the float64 sum at 128 slots,
    tools/spread_error.py); the kernel takes its moments about each
    window's center, where they cancel little, so it lands within 1e-3
    of the float64 sum and the two sides within 1e-2 of each other."""
    for name in ("counts", "nbox", "acc_true"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape and torch.equal(g, w), name
    for name in ("areas", "centroid", "extent"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=1e-5, atol=1e-5, msg=name)
    if var64 is not None:
        k_err, p_err, _, _ = spread_errors(got, want, var64)
        assert k_err <= 1e-3, f"kernel spread^2 off float64 by {k_err}"
        assert p_err <= 1e-2, f"plain spread^2 off float64 by {p_err}"
    torch.testing.assert_close(got.spread ** 2, want.spread ** 2,
                               rtol=1e-5, atol=1e-2)


ORACLE_CASES = [(f, m, p) for f in (1, 64, 1024) for m in (22, 128)
                for p in (1, 4, 8)] + [(1, 256, 8), (64, 256, 4),
                                       (1024, 256, 4)]


def oracle_card_args(f, m, seed, *, miss_rate=0.12, enabled_p=0.85):
    people = 14 if m == 22 else 100
    spec = SceneSpec(max_people=people, max_cars=m - people,
                     miss_rate=miss_rate)
    return spec, oracle_state(f, people, m - people, seed,
                              enabled_p=enabled_p)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f,m,p", ORACLE_CASES,
                         ids=[f"F{f}-M{m}-P{p}" for f, m, p in ORACLE_CASES])
def test_oracle_pass_kernel_on_card(cuda, f, m, p):
    spec, st = oracle_card_args(f, m, f + m + p)
    args, kw = oracle_args(st, spec, p, device=cuda)
    _lib.reset_launch_counts()
    got = oracle_pass(*args, **kw)
    assert _lib.launch_counts()["oracle_pass"] == 1
    assert sum(_lib.launch_counts().values()) == 1
    want = oracle_pass_plain(*args, **kw)
    assert_oracle_equal(got, want, oracle_variance_f64(args, kw))
    assert float(got.counts.sum()) > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", ["miss0", "miss1", "all_disabled",
                                  "bucket_edge", "no_cam_salt"])
def test_oracle_pass_edge_cases_on_card(cuda, case):
    """miss_rate 0 and 1, every camera disabled (acc_true 1.0), frames 2
    and 3 across a flicker bucket, no camera salt."""
    spec, st = oracle_card_args(
        64, 22, 9, miss_rate={"miss0": 0.0, "miss1": 1.0}.get(
            case, 0.12), enabled_p=0.0 if case == "all_disabled" else 0.85)
    if case == "bucket_edge":
        st["t"] = np.where(np.arange(64) % 2, 3, 2).astype(np.int64)
    args, kw = oracle_args(st, spec, 4, device=cuda)
    if case == "no_cam_salt":
        kw["cam_salt"] = None
    got = oracle_pass(*args, **kw)
    assert_oracle_equal(got, oracle_pass_plain(*args, **kw),
                        oracle_variance_f64(args, kw))
    if case in ("miss1", "all_disabled"):
        assert float(got.counts.sum()) == 0
    if case == "all_disabled":
        assert bool((got.acc_true == 1.0).all())


@pytest.mark.requires_cuda
def test_kernels_refuse_257_slots(cuda):
    """Past the new 256-slot limits, oracle_pass, cell_rasterize and
    crop_patchify raise naming the limit, before any launch."""
    spec, st = oracle_card_args(2, 257, 3)
    args, kw = oracle_args(st, spec, 4, device=cuda)
    _lib.reset_launch_counts()
    with pytest.raises(ValueError, match="256"):
        oracle_pass(*args, **kw)
    rargs = [t(x).to(cuda) for x in rasterize_inputs(2, 4, 1, m=257)]
    with pytest.raises(ValueError, match="256"):
        cell_rasterize(*rargs, n_moment=2)
    pargs = patchify_args(cuda, 2, 3, 64, 48, 257, False, seed=1)
    with pytest.raises(ValueError, match="256"):
        crop_patchify_batch(*pargs, res=64, patch=16, min_visible=0.25)
    # 256 slots of 64 px crops at D = 192: a 128-row tile spans 9 crops,
    # whose masks do not fit beside the 192-wide weight ring
    pargs = patchify_args(cuda, 2, 3, 64, 192, 256, False, seed=1)
    with pytest.raises(ValueError, match="shared memory"):
        crop_patchify_batch(*pargs, res=64, patch=16, min_visible=0.25)
    assert sum(_lib.launch_counts().values()) == 0


@pytest.mark.requires_cuda
def test_oracle_pass_refuses_other_kind_layout(cuda, monkeypatch):
    """The kernel reads a slot's kind as m >= max_people (PERSON, then
    CAR): a kind_mask laid out otherwise raises before any launch."""
    from repro_torch.kernels.oracle_pass import ops as orc
    spec, st = oracle_card_args(4, 22, 1)
    args, kw = oracle_args(st, spec, 4, device=cuda)
    monkeypatch.setattr(orc, "kind_mask", lambda s: 1 - np.where(
        np.arange(s.max_objects) < s.max_people, 0, 1))
    _lib.reset_launch_counts()
    with pytest.raises(ValueError, match="kind_mask"):
        oracle_pass(*args, **kw)
    assert _lib.launch_counts()["oracle_pass"] == 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shared", [False, True])
def test_crop_patchify_kernel_on_card(cuda, shared):
    pos, size, kind, oid, wins, pe, noise = patchify_inputs(
        4, 6, 48, seed=3, shared=shared)
    pos, size = t(pos).to(cuda), t(size).to(cuda)
    strips = [x.contiguous() for x in (pos[..., 0], pos[..., 1],
                                       size[..., 0], size[..., 1])]
    colors = object_colors(t(kind).to(cuda), t(oid).to(cuda)).contiguous()
    bgn = (render_background(64, cuda)[None] + t(noise).to(cuda))
    args = (*strips, colors, t(wins).to(cuda), bgn.contiguous(),
            t(pe["w"]).reshape(768, -1).to(cuda), t(pe["b"]).to(cuda))
    got = crop_patchify_batch(*args, res=64, patch=16, min_visible=0.25)
    want = crop_patchify_plain(*args, res=64, patch=16, min_visible=0.25)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def patchify_args(cuda, f, k, res, d, n_obj, shared, seed):
    """Seeded crop_patchify inputs with `n_obj` object slots (the last two
    disabled) and F x K windows of the default grid, on the card."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([0, 0], [150, 75], (f, n_obj, 2)).astype(np.float32)
    size = rng.uniform(1.5, 12.0, (f, n_obj, 2)).astype(np.float32)
    size[:, -2:] = 0.0
    kind = (np.arange(n_obj) >= n_obj // 2).astype(np.int64)
    oid = rng.integers(0, 4000, (f, n_obj))
    wins_all = window_arrays(DEFAULT_GRID)
    wins = (wins_all[:k] if shared else wins_all[np.stack(
        [rng.choice(wins_all.shape[0], k, replace=False) for _ in range(f)])])
    w = rng.normal(0, 1 / np.sqrt(768), (768, d)).astype(np.float32)
    b = rng.normal(0, 0.01, d).astype(np.float32)
    noise = (0.05 * rng.normal(0, 1, (f, res, res, 3))).astype(np.float32)
    pos, size = t(pos).to(cuda), t(size).to(cuda)
    strips = [x.contiguous() for x in (pos[..., 0], pos[..., 1],
                                       size[..., 0], size[..., 1])]
    colors = object_colors(t(kind).to(cuda), t(oid).to(cuda)).contiguous()
    bgn = (render_background(res, cuda)[None] + t(noise).to(cuda))
    return (*strips, colors, t(wins).to(cuda), bgn.contiguous(),
            t(w).to(cuda), t(b).to(cuda))


# (F, K, res, D, shared): 224 px with F*K*196 not a multiple of the
# kernel's 128-row tile, and 64 px where one tile spans up to 9 crops
PATCHIFY_CASES = [(3, 5, 224, 192, False), (3, 5, 224, 192, True),
                  (4, 6, 64, 48, False), (4, 6, 64, 48, True),
                  (5, 7, 64, 192, False),
                  (2, 3, 64, 200, True)]       # two feature tiles


# (F, K, res, D, object slots): ownership in 2, 4 and 8 words (40, 70,
# 129 and 256 slots; colours from global memory at 8 words) at the
# full-width detector's 224 px and, at the smoke detector's width, where
# a tile spans 9 crops
MANY_SLOT_CASES = [(3, 5, 224, 192, 40), (2, 4, 224, 192, 70),
                   (2, 3, 224, 192, 256), (4, 6, 64, 48, 129),
                   (5, 7, 64, 48, 256)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", MANY_SLOT_CASES,
                         ids=[str(c) for c in MANY_SLOT_CASES])
def test_crop_patchify_many_slots_on_card(cuda, case):
    f, k, res, d, n_obj = case
    args = patchify_args(cuda, f, k, res, d, n_obj, False, seed=n_obj + f)
    _lib.reset_launch_counts()
    got = crop_patchify_batch(*args, res=res, patch=16, min_visible=0.25)
    assert _lib.launch_counts()["crop_patchify"] == 1
    want = crop_patchify_plain(*args, res=res, patch=16, min_visible=0.25)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", PATCHIFY_CASES,
                         ids=[str(c) for c in PATCHIFY_CASES])
def test_crop_patchify_row_tiles_on_card(cuda, case):
    """The kernel's row tiles straddle crops and end ragged; 32 objects
    fill every ownership lane."""
    f, k, res, d, shared = case
    args = patchify_args(cuda, f, k, res, d, 32, shared, seed=res + f)
    _lib.reset_launch_counts()
    got = crop_patchify_batch(*args, res=res, patch=16, min_visible=0.25)
    assert _lib.launch_counts()["crop_patchify"] == 1
    want = crop_patchify_plain(*args, res=res, patch=16, min_visible=0.25)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def search_args(cuda, grid, f, seed):
    """(cfg, statics, shape_search args, budget_walk args after the
    shape) on the card, from a seeded state with ties; budgets that fit
    nothing, everything and in between."""
    n = grid.n_cells
    shape, labels, has, cent = search_state(grid, f, seed)
    rng = np.random.default_rng(seed + 1)
    max_cells = rng.integers(0, n + 3, f)
    start = rng.integers(0, n, f)
    budget = rng.uniform(0.0, 0.6, f).astype(np.float32)
    budget[::5] = 0.0
    budget[1::5] = 1e3
    cfg = tstate.fleet_config(grid)
    statics = tstate.fleet_statics(grid, cuda)
    ss = [t(x).to(cuda) for x in (shape, labels, cent, has, max_cells)]
    bw = [t(x).to(cuda) for x in (start, labels, budget)]
    return cfg, statics, ss, bw


SEARCH_CASES = ([(f, n) for n in (25, 50, 128) for f in (1, 64, 1024)]
                + [(1, 200), (64, 200)])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("f,n", SEARCH_CASES,
                         ids=[f"F{f}-N{n}" for f, n in SEARCH_CASES])
def test_shape_search_kernel_on_card(cuda, f, n):
    cfg, statics, args, _ = search_args(cuda, SEARCH_GRIDS[n], f, f + n)
    _lib.reset_launch_counts()
    got = shape_search_batch(cfg, statics, *args)
    assert _lib.launch_counts()["shape_search"] == 1
    want = shape_search_plain(cfg, statics, *args)
    assert torch.equal(got, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("per_cell", [0.0, 0.004])
@pytest.mark.parametrize("f,n", SEARCH_CASES,
                         ids=[f"F{f}-N{n}" for f, n in SEARCH_CASES])
def test_budget_walk_kernel_on_card(cuda, f, n, per_cell):
    cfg, statics, ss, (start, labels, budget) = search_args(
        cuda, SEARCH_GRIDS[n], f, 2 * f + n)
    mask = ss[0]
    _lib.reset_launch_counts()
    got = budget_walk_batch(cfg, statics, mask, start, labels, budget,
                            per_cell)
    assert _lib.launch_counts()["budget_walk"] == 1
    want = budget_walk_plain(cfg, statics, mask, start, labels, budget,
                             per_cell)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    torch.testing.assert_close(got[3], want[3], rtol=1e-6, atol=0)


@pytest.mark.requires_cuda
def test_wrappers_reject_bad_input(cuda):
    args = [t(x).to(cuda) for x in rasterize_inputs(2, 2, 0)]
    with pytest.raises(TypeError):
        cell_rasterize(*args[:4], args[4].double(), *args[5:])
    with pytest.raises(ValueError):
        cell_rasterize(args[0].t(), *args[1:])

    cfg, statics, ss, (start, labels, budget) = search_args(
        cuda, DEFAULT_GRID, 4, 0)
    shape, _, cent, has, max_cells = ss
    with pytest.raises(TypeError):                     # float64 labels
        shape_search_batch(cfg, statics, shape, labels.double(), cent, has,
                           max_cells)
    with pytest.raises(TypeError):                     # int32 start
        budget_walk_batch(cfg, statics, shape, start.int(), labels, budget,
                          0.0)
    with pytest.raises(ValueError):                    # CPU labels
        shape_search_batch(cfg, statics, shape, labels.cpu(), cent, has,
                           max_cells)
    with pytest.raises(ValueError):                    # CPU budget
        budget_walk_batch(cfg, statics, shape, start, labels, budget.cpu(),
                          0.0)
    with pytest.raises(ValueError):                    # not contiguous
        shape_search_batch(cfg, statics, shape, labels, cent.transpose(0, 1),
                           has, max_cells)
    # 200 cells (20 x 10, four-word sets) run and agree with the plain
    # versions; more than 512 cells (30 x 20) raise, naming the limit
    big = OrientationGrid(pan_step=7.5, tilt_step=7.5)
    cfg, statics, ss, (start, labels, budget) = search_args(cuda, big, 2, 0)
    assert torch.equal(shape_search_batch(cfg, statics, *ss),
                       shape_search_plain(cfg, statics, *ss))
    got = budget_walk_batch(cfg, statics, ss[0], start, labels, budget, 0.0)
    want = budget_walk_plain(cfg, statics, ss[0], start, labels, budget, 0.0)
    assert all(torch.equal(g, w) for g, w in zip(got[:3], want[:3]))
    huge = OrientationGrid(pan_step=5.0, tilt_step=3.75)
    assert huge.n_cells > 512
    cfg, statics, ss, (start, labels, budget) = search_args(cuda, huge, 2,
                                                            0)
    with pytest.raises(ValueError, match="512"):
        shape_search_batch(cfg, statics, *ss)
    with pytest.raises(ValueError, match="512"):
        budget_walk_batch(cfg, statics, ss[0], start, labels, budget, 0.0)


# (B, Sq, Sk, Hq, Hkv, D, causal, q_offset, dtype)
FLASH_CASES = [
    (3, 197, 197, 6, 6, 32, False, 0, torch.float32),   # the ViT's layer
    (2, 100, 100, 2, 1, 24, True, 0, torch.float32),    # ragged + MQA
    (1, 1, 96, 4, 4, 16, False, 0, torch.float32),      # decode shape
    (2, 72, 136, 4, 2, 48, False, 0, torch.float32),    # Sq != Sk, GQA
    (1, 130, 130, 4, 4, 80, True, 0, torch.float32),    # stablelm's D
    (1, 8, 40, 4, 2, 64, True, 32, torch.float32),      # q_offset
    (1, 8, 8, 2, 2, 16, True, -4, torch.float32),       # masked rows -> 0
    (1, 256, 256, 2, 2, 128, True, 0, torch.float32),
    (2, 64, 64, 4, 2, 64, False, 0, torch.bfloat16),
    (2, 197, 197, 3, 3, 32, False, 0, torch.bfloat16),  # ViT S in bf16
    (1, 300, 300, 4, 2, 64, True, 37, torch.float32),   # several key tiles
    (1, 300, 300, 4, 2, 80, True, 37, torch.bfloat16),
    (1, 70, 70, 2, 1, 18, True, 0, torch.float32),      # rows not 16-byte
    (1, 70, 90, 2, 1, 20, False, 0, torch.bfloat16),    # multiples
] + [(1 + (dt == torch.float32), 150, 150, 4, 2, d, True, 0, dt)
     for d in (16, 24, 32, 48, 64, 80, 96, 128, 144, 192, 256)  # every
     for dt in (torch.float32, torch.bfloat16)] + [         # head dim
    (2, 100, 164, 4, 2, 192, True, 64, torch.float32),  # MLA's q/k width
    (1, 300, 300, 2, 2, 256, False, 0, torch.float32),  # several tiles
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(c[:8]) for c in FLASH_CASES])
def test_flash_attention_kernel_on_card(cuda, case):
    b, sq, sk, hq, hkv, d, causal, q_offset, dtype = case
    gen = torch.Generator().manual_seed(sq + d)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, dtype)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                             (b, sk, hkv, d)))
    _lib.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert _lib.launch_counts()["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    tol = 2e-2 if dtype == torch.bfloat16 else 3e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.requires_cuda
def test_flash_attention_rejects_bad_input(cuda):
    q = torch.zeros(1, 4, 2, 264, device=cuda)
    with pytest.raises(ValueError, match="256"):
        flash_attention(q, q, q)                        # D > 256
    q = torch.zeros(1, 4, 2, 16, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                        q.transpose(1, 2))


F32, BF16 = torch.float32, torch.bfloat16
# (B, Sq, Sk, Hq, Hkv, D, causal, q_offset, dtype, keys held resident):
# the resident path at Sk 1, 63, 197 and 256 and the tiled loop just past
# it (0; past 32 head dims up to 128 keys are held), in both types;
# causal with q_offset (rows with no key among them), GQA, queries past
# one item's four tiles, more items than SMs; the kernel table's GQA and
# bf16 rows
RESIDENT_CASES = [
    (3, 1, 1, 4, 4, 32, False, 0, F32, 64),
    (3, 63, 63, 4, 4, 32, False, 0, F32, 64),
    (3, 197, 197, 6, 6, 32, False, 0, F32, 200),
    (2, 256, 256, 4, 4, 32, False, 0, F32, 256),
    (2, 257, 257, 4, 4, 32, False, 0, F32, 0),
    (2, 128, 128, 4, 4, 64, False, 0, F32, 128),
    (2, 129, 129, 4, 4, 64, False, 0, F32, 0),
    (3, 1, 1, 4, 4, 64, False, 0, BF16, 64),
    (3, 63, 63, 4, 4, 64, False, 0, BF16, 64),
    (3, 197, 197, 6, 6, 32, False, 0, BF16, 208),
    (2, 256, 256, 4, 4, 32, False, 0, BF16, 256),
    (2, 257, 257, 4, 4, 32, False, 0, BF16, 0),
    (2, 128, 128, 4, 4, 64, False, 0, BF16, 128),
    (2, 129, 129, 4, 4, 64, False, 0, BF16, 0),
    (2, 197, 197, 4, 2, 32, True, 0, F32, 200),
    (2, 300, 120, 4, 4, 32, True, -180, F32, 128),
    (2, 63, 63, 4, 1, 32, True, 5, BF16, 64),
    (300, 197, 197, 2, 1, 24, False, 0, F32, 200),
    (4, 100, 164, 8, 2, 64, True, 64, F32, 0),
    (64, 256, 256, 8, 8, 64, False, 0, BF16, 0),
]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", RESIDENT_CASES,
                         ids=[str(c[:9]) for c in RESIDENT_CASES])
def test_flash_attention_resident_path_on_card(cuda, case):
    """The launcher holds K and V resident exactly where the case says,
    and both paths match the plain version (3e-5 float32, 2e-2 bf16)."""
    b, sq, sk, hq, hkv, d, causal, q_offset, dtype, keys = case
    assert resident_keys(sk, d, dtype) == keys
    gen = torch.Generator().manual_seed(sq * 7 + sk + d)
    q, k, v = (torch.randn(shape, generator=gen).to(cuda, dtype)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                             (b, sk, hkv, d)))
    _lib.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    assert _lib.launch_counts()["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset)
    tol = 2e-2 if dtype == torch.bfloat16 else 3e-5
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.requires_cuda
def test_detector_attention_on_flash_at_full_width(cuda, monkeypatch):
    """madeye-approx's detector on the tokens of a run_fleet step's 1,152
    shortlisted crops (64 cameras x 18, the fused path), without
    gradients as the fleet runs it: attention takes the flash kernel,
    one launch a layer, and the post-neck features and the top-32 scores
    are within 1e-4 of the same forward with impl="xla". Both in full
    float32, as the fleet runs them (layers.full_float32: cuDNN's TF32
    convolutions in the neck would round the two apart by ~1e-3)."""
    seen, forward = [], runner_module.detector_forward_tokens

    def kept(dp, cfg, tokens):
        seen.append((dp, cfg, tokens.clone()))
        return forward(dp, cfg, tokens)

    monkeypatch.setattr(runner_module, "detector_forward_tokens", kept)
    run_fleet(FleetRunSpec(provider="detector", n_cameras=64, n_steps=1,
                           shortlist_k=18, provider_kwargs={
                               "det_cfg": get_config("madeye-approx")}))
    params, cfg, tokens = seen[-1]
    assert tokens.shape[0] == 64 * 18
    with torch.no_grad(), full_float32():
        assert det.vit_attention_impl(tokens, params["backbone"]["vit"]) \
            == "flash"
        _lib.reset_launch_counts()
        feats = det.detector_neck_feats_tokens(params, cfg, tokens)
        scores = det.detector_forward_tokens(params, cfg, tokens).scores
        assert _lib.launch_counts()["flash_attention"] == 2 * cfg.n_layers
        monkeypatch.setattr(det, "vit_attention_impl", lambda *a: "xla")
        _lib.reset_launch_counts()
        want_feats = det.detector_neck_feats_tokens(params, cfg, tokens)
        want_scores = det.detector_forward_tokens(params, cfg,
                                                  tokens).scores
        assert _lib.launch_counts()["flash_attention"] == 0
    torch.testing.assert_close(feats, want_feats, rtol=0, atol=1e-4)
    torch.testing.assert_close(scores, want_scores, rtol=0, atol=1e-4)


# widths that are and are not multiples of 4 (16-byte rows or scalar
# stores), ragged column blocks and row slabs
BOX_IOU_CASES = [(1, 1), (37, 13), (300, 517), (3, 4), (4, 3), (1, 4095),
                 (4095, 4), (9217, 3), (3, 9217), (4095, 4095),
                 (9217, 9217)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,m", BOX_IOU_CASES)
def test_box_iou_kernel_on_card(cuda, n, m):
    """Bit-equal to the plain version (the same float32 operations in
    the same order; a skipped division is exact), on boxes where a
    tenth have zero width or height and some repeat exactly."""
    gen = torch.Generator().manual_seed(n + m)
    a = torch.rand(n, 4, generator=gen) * 0.3 + 0.05
    b = torch.rand(m, 4, generator=gen) * 0.3 + 0.05
    for x in (a, b):
        x[torch.rand(x.shape[0], generator=gen) < 0.05, 2] = 0.0
        x[torch.rand(x.shape[0], generator=gen) < 0.05, 3] = 0.0
    b[: min(n, m) // 2] = a[: min(n, m) // 2]
    a, b = a.to(cuda), b.to(cuda)
    _lib.reset_launch_counts()
    got = box_iou(a, b)
    assert _lib.launch_counts()["box_iou"] == 1
    want = box_iou_plain(a, b)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.requires_cuda
def test_nms_and_matching_card_equals_cpu(cuda):
    gen = torch.Generator().manual_seed(4)
    for _ in range(4):
        boxes = torch.cat([0.3 + 0.4 * torch.rand(32, 2, generator=gen),
                           0.05 + 0.2 * torch.rand(32, 2, generator=gen)], 1)
        scores = torch.round(torch.rand(32, generator=gen) * 10) / 10
        valid = torch.rand(32, generator=gen) < 0.8
        cpu = nms_mask(boxes, scores, valid)
        card = nms_mask(boxes.to(cuda), scores.to(cuda), valid.to(cuda))
        assert torch.equal(card.cpu(), cpu)
        gt = boxes.flip(0)[:20]
        cpu = match_boxes(boxes, gt, valid[:20])
        card = match_boxes(boxes.to(cuda), gt.to(cuda), valid[:20].to(cuda))
        for c, g in zip(card, cpu):
            assert torch.equal(c.cpu(), g)


@pytest.mark.requires_cuda
def test_kernel_apis_launch_once_a_call(cuda):
    """box_iou, nms_mask and match_boxes launch box_iou once a call,
    frame_delta and rmsnorm their kernels once."""
    gen = torch.Generator().manual_seed(5)
    boxes = torch.cat([torch.rand(32, 2, generator=gen),
                       0.05 + 0.2 * torch.rand(32, 2, generator=gen)],
                      1).to(cuda)
    scores = torch.rand(32, generator=gen).to(cuda)
    frame = torch.rand(64, 256, 3, generator=gen).to(cuda)
    rows = torch.randn(8, 256, generator=gen).to(cuda)
    for fn, name in (
            (lambda: box_iou(boxes, boxes), "box_iou"),
            (lambda: nms_mask(boxes, scores, scores > 0.2), "box_iou"),
            (lambda: match_boxes(boxes, boxes.flip(0), scores > 0.5),
             "box_iou"),
            (lambda: frame_delta(frame, frame.flip(0)), "frame_delta"),
            (lambda: rmsnorm(rows, torch.ones(256, device=cuda)),
             "rmsnorm")):
        _lib.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        assert {k: v for k, v in _lib.launch_counts().items() if v} == {
            name: 1}


# aligned rows (W * 3 a multiple of 16: 16-float items) and unaligned
# ones (scalar items), tiles in registers and tiles past them (a second
# read), edge tiles in both directions, and one 1080p frame
FRAME_DELTA_CASES = [(64, 128, (16, 128)), (100, 200, (16, 128)),
                     (37, 53, (8, 16)), (40, 160, (8, 16)),
                     (48, 256, (16, 64)), (37, 53, (16, 64)),
                     (70, 130, (16, 128)), (64, 512, (64, 256)),
                     (50, 300, (32, 100)), (1080, 1920, (16, 128))]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("h,w,tile", FRAME_DELTA_CASES)
def test_frame_delta_kernel_on_card(cuda, h, w, tile):
    gen = torch.Generator().manual_seed(h)
    cur = torch.rand(h, w, 3, generator=gen)
    prev = cur.clone()
    prev[: h // 2, : w // 2] = (prev[: h // 2, : w // 2] + 0.3).clamp(0, 1)
    cur, prev = cur.to(cuda), prev.to(cuda)
    th, tw = tile
    dq, changed, _ = frame_delta(cur, prev, tile_h=th, tile_w=tw)
    dq_p, changed_p = frame_delta_plain(cur, prev, tile_h=th, tile_w=tw)
    assert torch.equal(changed, changed_p) and torch.equal(dq, dq_p)
    assert 0 < int(changed.sum()) < changed.numel()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("shape,dtype", [((4, 16, 64), torch.float32),
                                         ((7, 33), torch.float32),
                                         ((3, 2560), torch.float32),
                                         ((2, 100, 256), torch.bfloat16)])
def test_rmsnorm_kernel_on_card(cuda, shape, dtype):
    gen = torch.Generator().manual_seed(shape[-1])
    x = torch.randn(shape, generator=gen).to(cuda, dtype)
    w = (torch.randn(shape[-1], generator=gen) + 1.0).to(cuda)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(rmsnorm(x, w), rmsnorm_plain(x, w),
                               rtol=tol, atol=tol)


def _empty_search(name, d):
    """shape_search or budget_walk over zero cameras."""
    cfg = tstate.fleet_config(DEFAULT_GRID)
    st = tstate.fleet_statics(DEFAULT_GRID, d)
    n = DEFAULT_GRID.n_cells
    mask = torch.zeros(0, n, dtype=torch.bool, device=d)
    labels = torch.zeros(0, n, device=d)
    none = torch.zeros(0, dtype=torch.int64, device=d)
    if name == "shape_search":
        return shape_search_batch(cfg, st, mask, labels,
                                  torch.zeros(0, n, 2, device=d), mask, none)
    return budget_walk_batch(cfg, st, mask, none, labels,
                             torch.zeros(0, device=d), 0.0)


def _empty_oracle(d):
    """oracle_pass over zero cameras."""
    args, kw = oracle_args(oracle_state(0, 14, 8, 0), SceneSpec(), 4,
                           device=d)
    return oracle_pass(*args, **kw)


EMPTY_CASES = {
    "shape_search": lambda d: _empty_search("shape_search", d),
    "budget_walk": lambda d: _empty_search("budget_walk", d),
    "box_iou": lambda d: box_iou(torch.zeros(0, 4, device=d),
                                 torch.zeros(5, 4, device=d)),
    "flash_attention": lambda d: flash_attention(
        *(torch.zeros(2, 0, 4, 32, device=d),) * 3),
    "frame_delta": lambda d: frame_delta(torch.zeros(16, 128, 0, device=d),
                                         torch.zeros(16, 128, 0, device=d)),
    "rmsnorm": lambda d: rmsnorm(torch.zeros(0, 64, device=d),
                                 torch.ones(64, device=d)),
    "oracle_pass": lambda d: _empty_oracle(d),
}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("name", sorted(EMPTY_CASES))
def test_empty_input_launches_nothing(cuda, name):
    """An empty input returns an empty result without a launch, so a
    launch count always means a kernel ran."""
    _lib.reset_launch_counts()
    out = EMPTY_CASES[name](cuda)
    assert _lib.launch_counts()[name] == 0
    if name == "frame_delta":
        assert out[0].numel() == 0 and int(out[1].abs().sum()) == 0
    elif name in ("budget_walk", "oracle_pass"):
        assert all(x.numel() == 0 for x in out)
    else:
        assert out.numel() == 0


MAIN_PATH_KERNELS = ("shape_search", "budget_walk", "oracle_pass",
                     "crop_patchify")
# scene/prng.py's public draws, one threefry launch each on the card: a
# detector step at stride 1 makes 16 in the scene advance (fold_in, split
# x 3, randint x 4, normal x 5, uniform x 3) and 3 in the render noise
# (fold_in x 2, normal)
STEP_DRAWS = 16 + 3
VIT_LINEARS = 36            # q, k, v, o, up, down in each of 6 layers
VIT_LAYERS = 6              # one flash_attention launch each


def _record(monkeypatch, module, name, calls):
    """Keep (args, kwargs, result) clones of every call of module.name
    (the name its callers look up)."""
    fn = getattr(module, name)

    def recorded(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((clone_tree(args), clone_tree(kwargs),
                      clone_tree(out)))
        return out

    monkeypatch.setattr(module, name, recorded)


# (distill, steps, dense and flash_attention launches a step): head-only
# distillation runs the shared backbone once over the shortlist, as the
# frozen path; full mode runs each camera's network under vmap, where
# linear keeps torch's product and attention its plain path (its depth
# cut to 3 steps for the card's memory)
MAIN_PATH_CASES = [(None, 8, VIT_LINEARS, VIT_LAYERS),
                   (DistillSpec(), 8, VIT_LINEARS, VIT_LAYERS),
                   (DistillSpec(head_only=False), 3, 0, 0)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("distill,n_steps,dense,flash", MAIN_PATH_CASES,
                         ids=["frozen", "distill", "distill-full"])
def test_main_path_at_full_width(cuda, distill, n_steps, dense, flash,
                                 monkeypatch):
    n_cameras = 64
    steps = n_steps + 1                         # and the warm-up step
    calls = {"oracle_pass": [], "shape_search_batch": [],
             "budget_walk_batch": []}
    _record(monkeypatch, observe_module, "oracle_pass",
            calls["oracle_pass"])
    for name in ("shape_search_batch", "budget_walk_batch"):
        _record(monkeypatch, step_module, name, calls[name])
    draws, per_step = count_card_draws(monkeypatch), []
    step_fn = runner_module.episode_step

    def counted_step(*args, **kwargs):
        before = _lib.LAUNCHES["threefry"]
        out = step_fn(*args, **kwargs)
        per_step.append(_lib.LAUNCHES["threefry"] - before)
        return out

    for module in (api_module, runner_module):
        monkeypatch.setattr(module, "episode_step", counted_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = FleetRunSpec(provider="detector", n_cameras=n_cameras,
                        n_steps=n_steps, shortlist_k=18, distill=distill,
                        provider_kwargs={
                            "det_cfg": get_config("madeye-approx")})
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    result = run_fleet(spec)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _lib.launch_counts().items() if v}

    # no draw on the card ran the plain version
    assert counts.pop("threefry") == draws[0]
    assert per_step == [STEP_DRAWS] * steps
    assert counts == {k: steps for k in MAIN_PATH_KERNELS} | (
        {"dense": dense * steps, "flash_attention": flash * steps}
        if dense else {})
    chosen = torch.tensor(result.chosen)
    acc = torch.tensor(result.acc_per_step)
    assert chosen.shape == (n_steps, n_cameras)
    assert bool(((chosen >= 0) & (chosen < DEFAULT_GRID.n_cells)).all())
    assert bool(((acc >= 0) & (acc <= 1)).all())
    assert len(result.frames_sent) == n_steps

    assert [len(c) for c in calls.values()] == [steps] * 3
    for args, kw, got in calls["oracle_pass"]:
        assert_oracle_equal(got, oracle_pass_plain(*args, **kw))
    for name, plain in (("shape_search_batch", shape_search_plain),
                        ("budget_walk_batch", budget_walk_plain)):
        for args, _, got in calls[name]:
            want = plain(*args)
            got, want = ((got, want) if isinstance(got, tuple)
                         else ((got,), (want,)))
            for g, w in zip(got, want):
                if g.dtype == torch.float32:    # the walk's hop sum
                    torch.testing.assert_close(g, w, rtol=1e-6, atol=0)
                else:
                    assert torch.equal(g, w), name
