"""The port's unfused detector reference (`fused=False`), its renderer,
the image-level detector forward and `materialize_scene_tables`, against
the JAX package and against the port's own fused path, on the same
seeded inputs.

Tolerances:
  * crops from `render_fleet_crops`: within 6e-8 (one float32 ulp of a
    pixel) of `repro`'s, so the same owner paints every pixel:
    inside its jitted program XLA contracts some of the background's
    multiply-adds into FMAs (the same background evaluated op by op is
    bit-equal to the port's); at M <= 32 object slots bit-equal to
    `repro`'s packed statement of the same crops
    (kernels/crop_patchify/ref._render_crops_packed), as
    tests/test_torch_kernels.py holds the plain renderer;
  * `detector_forward`: scores and boxes within 1e-4 of `repro`'s after
    the whole forward, the top-k cells equal (tests/test_torch_detector.py);
  * the port's `fused=False` against its `fused=True` at shortlist_k =
    N*Z: decisions and `chosen` equal, `pred_acc` and `acc_chosen`
    bit-equal. Both paths render with the one renderer and embed with
    the one `patch_embed`; the unfused path runs the detector over
    slabs of [F * chunk] crops, the fused one over all [F * N * Z] at
    once, so the equality also needs every operation to give a row the
    same bits at any batch size. PyTorch's CPU GELU (tanh) and sigmoid
    do not when they run on several threads (each thread's share of the
    elements ends in a scalar tail that rounds otherwise), so this file
    runs on one intra-op thread, as the port's other test files do;
  * `fused=False` against `repro`'s at equal F: decisions equal;
  * `materialize_scene_tables`: the oracle tolerances (counts, nbox and
    acc_true exact; areas, centroid and extent 1e-5; spread as a
    variance 1e-2), and its tables episode decides exactly as the scene
    episode it recorded, pred_acc within 1e-6.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the fused/unfused bit-equality needs it (above)
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import DEFAULT_GRID as JGRID  # noqa: E402
from repro.core.tradeoff import BudgetConfig as JBudget  # noqa: E402
from repro.fleet import fleet_config as j_fleet_config  # noqa: E402
from repro.fleet import fleet_statics as j_fleet_statics  # noqa: E402
from repro.fleet import make_detector_provider as j_make_detector  # noqa: E402
from repro.fleet import make_scene_provider as j_make_scene  # noqa: E402
from repro.fleet import materialize_scene_tables as j_materialize  # noqa: E402
from repro.fleet import run_fleet_episode as j_episode  # noqa: E402
from repro.fleet import workload_spec as j_workload_spec  # noqa: E402
from repro.fleet.api import FleetRunSpec as JSpec  # noqa: E402
from repro.kernels.crop_patchify.ref import _render_crops_packed  # noqa: E402
from repro.learn.spec import DistillSpec as JDistill  # noqa: E402
from repro.models import detector as jdet  # noqa: E402
from repro.scene_jax.render import render_crop as j_render_crop  # noqa: E402
from repro.scene_jax.render import render_fleet_crops as j_render  # noqa: E402
from repro_torch.core import DEFAULT_GRID as TGRID  # noqa: E402
from repro_torch.core.tradeoff import BudgetConfig as TBudget  # noqa: E402
from repro_torch.fleet import fleet_config as t_fleet_config  # noqa: E402
from repro_torch.fleet import fleet_statics as t_fleet_statics  # noqa: E402
from repro_torch.fleet import make_detector_provider as t_make_detector  # noqa: E402
from repro_torch.fleet import make_scene_provider as t_make_scene  # noqa: E402
from repro_torch.fleet import materialize_scene_tables as t_materialize  # noqa: E402
from repro_torch.fleet import run_fleet_episode as t_episode  # noqa: E402
from repro_torch.fleet import workload_spec as t_workload_spec  # noqa: E402
from repro_torch.fleet.api import FleetRunSpec as TSpec  # noqa: E402
from repro_torch.learn.spec import DistillSpec as TDistill  # noqa: E402
from repro_torch.models import detector as tdet  # noqa: E402
from repro_torch.scene.render import render_background  # noqa: E402
from repro_torch.scene.render import render_crop as t_render_crop  # noqa: E402
from repro_torch.scene.render import render_fleet_crops as t_render  # noqa: E402
from torch_kernel_inputs import patchify_inputs, t  # noqa: E402

DECISIONS = ("explored", "order", "n_explored", "zooms", "sent", "k_send",
             "chosen")
JWL = JSpec().workload_obj()
TWL = TSpec().workload_obj()
JCFG = j_fleet_config(JGRID, JBudget(fps=2.0))
TCFG = t_fleet_config(TGRID, TBudget(fps=2.0))
DCFG = get_smoke_config("madeye-approx")


def _out(o):
    return {k: np.asarray(getattr(o, k)) for k in o._fields}


def _t_episode(cfg, provider, st, **kw):
    with torch.no_grad():
        _, out, ex, _ = t_episode(cfg, t_workload_spec(TWL),
                                  t_fleet_statics(TGRID), st, provider,
                                  **kw)
    return _out(out), ex


def _j_episode(cfg, provider, st):
    _, out = j_episode(cfg, j_workload_spec(JWL), j_fleet_statics(JGRID),
                       st, provider)
    return _out(out)


# ---------------------------------------------------------------------------
# the renderer and the image-level forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [22, 40])
@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("shared", [True, False])
def test_render_fleet_crops_matches_jax(shared, noise, m):
    pos, size, kind, oid, wins, _, nz = patchify_inputs(
        3, 5, 8, seed=m + 7 * shared + 3 * noise, shared=shared, m=m)
    nz = nz if noise else None
    jargs = [jnp.asarray(x) for x in (pos, size, kind, oid, wins)]
    jnz = None if nz is None else jnp.asarray(nz)
    want = np.asarray(j_render(*jargs, res=64, min_visible=0.25,
                               noise=jnz))
    got = t_render(t(pos), t(size), t(kind), t(oid), t(wins), res=64,
                   min_visible=0.25,
                   noise=None if nz is None else t(nz)).numpy()
    assert got.shape == want.shape == (3, 5, 64, 64, 3)
    # one ulp, while two owners' colours differ by far more: the same
    # owner paints every pixel
    np.testing.assert_allclose(got, want, rtol=0, atol=6e-8)
    bg = np.clip(render_background(64).numpy() + (0 if nz is None else
                                                  nz[:, None]), 0, 1)
    assert (np.abs(got - bg) > 1e-6).mean() > 0.01        # boxes painted
    if m <= 32:
        packed = _render_crops_packed(*jargs, jnz, res=64, min_visible=0.25)
        np.testing.assert_array_equal(got, np.asarray(packed))


def test_render_crop_matches_jax():
    pos, size, kind, oid, wins, _, nz = patchify_inputs(1, 4, 8, seed=3,
                                                        shared=True)
    for w in range(4):
        want = j_render_crop(jnp.asarray(pos[0]), jnp.asarray(size[0]),
                             jnp.asarray(kind), jnp.asarray(oid[0]),
                             jnp.asarray(wins[w]), res=64,
                             noise_img=jnp.asarray(nz[0]))
        got = t_render_crop(t(pos[0]), t(size[0]), t(kind), t(oid[0]),
                            t(wins[w]), res=64, noise_img=t(nz[0]))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_detector_forward_matches_jax():
    jp = jdet.detector_init(jax.random.PRNGKey(4), DCFG)
    tp = tdet.params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (5, 64, 64, 3)).astype(np.float32)
    want = jdet.detector_forward(jp, DCFG, jnp.asarray(imgs))
    got = tdet.detector_forward(tp, DCFG, torch.as_tensor(imgs))
    for name in ("scores", "boxes", "class_probs"):
        np.testing.assert_allclose(getattr(got, name).detach().numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-4, rtol=0, err_msg=name)
    # the image forward is the token forward on vit_embed's tokens
    tok = tdet.vit.vit_embed(tp["backbone"]["vit"], torch.as_tensor(imgs),
                             patch=DCFG.patch)
    again = tdet.detector_forward_tokens(tp, DCFG, tok)
    assert torch.equal(again.scores, got.scores)


# ---------------------------------------------------------------------------
# the unfused episode
# ---------------------------------------------------------------------------

def test_unfused_matches_fused_exhaustive():
    """fused=False makes the decisions of fused=True at shortlist_k =
    N*Z, with bit-equal pred_acc and acc_chosen (tests/test_fleet_parity
    .py:286 asks the same of the reference)."""
    provider, st = t_make_detector(TGRID, TWL, TCFG, n_cameras=2,
                                   n_steps=4, scene_seeds=[5, 9],
                                   device="cpu")
    assert provider.fused and provider.shortlist_k == TGRID.n_cells * 3
    fast, _ = _t_episode(TCFG, provider, st)
    ref, _ = _t_episode(TCFG, dataclasses.replace(provider, fused=False),
                        st)
    for name in DECISIONS + ("pred_acc", "acc_chosen"):
        np.testing.assert_array_equal(fast[name], ref[name], err_msg=name)
    assert fast["k_send"].sum() > 0


def test_unfused_matches_jax():
    """At equal F (2 cameras, 4 steps) the port's fused=False decides as
    repro's, on the same JAX-drawn weights."""
    jp = jdet.detector_init(jax.random.PRNGKey(1), DCFG)
    kw = dict(n_cameras=2, n_steps=4, scene_seeds=[5, 9], thresh=0.3,
              fused=False)
    jprov, jst = j_make_detector(JGRID, JWL, JCFG, det_params=jp, **kw)
    tprov, tst = t_make_detector(TGRID, TWL, TCFG,
                                 det_params=jax.tree.map(np.asarray, jp),
                                 device="cpu", **kw)
    assert not jprov.fused and not tprov.fused
    want = _j_episode(JCFG, jprov, jst)
    got, _ = _t_episode(TCFG, tprov, tst)
    for name in DECISIONS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    np.testing.assert_allclose(got["acc_chosen"], want["acc_chosen"],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", ["chunk", "shortlist", "distill"])
def test_unfused_refusals_match_jax(case):
    """The provider's refusals and their messages are the reference's."""
    kw = {"chunk": dict(chunk=7),
          "shortlist": dict(fused=False, shortlist_k=18),
          "distill": dict(fused=False)}[case]
    with pytest.raises(ValueError) as want:
        j_make_detector(JGRID, JWL, JCFG, n_cameras=1, n_steps=1,
                        distill=JDistill() if case == "distill" else None,
                        **kw)
    with pytest.raises(ValueError) as got:
        t_make_detector(TGRID, TWL, TCFG, n_cameras=1, n_steps=1,
                        distill=TDistill() if case == "distill" else None,
                        device="cpu", **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# materialize_scene_tables
# ---------------------------------------------------------------------------

def _assert_tables_close(got, want):
    for name in ("counts", "nbox", "acc_true"):
        np.testing.assert_array_equal(got[name].astype(np.float64),
                                      want[name].astype(np.float64),
                                      err_msg=name)
    for name in ("areas", "centroid", "extent", "mbps", "rtt"):
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(got["spread"] ** 2, want["spread"] ** 2,
                               atol=1e-2, rtol=1e-5)


def test_materialize_scene_tables_matches_jax_and_replays():
    """A homogeneous 3-camera fleet over 14 steps: the recorded tables
    equal repro's, and the tables episode decides as the scene episode
    (tests/test_fleet_parity.py:134 asks this of the reference)."""
    kw = dict(n_cameras=3, n_steps=14, scene_seeds=[7, 7, 7])
    jprov, jst = j_make_scene(JGRID, JWL, JCFG, **kw)
    tprov, tst = t_make_scene(TGRID, TWL, TCFG, device="cpu", **kw)
    jtab = j_materialize(JCFG, j_workload_spec(JWL), j_fleet_statics(JGRID),
                         jst, jprov)
    ttab = t_materialize(TCFG, t_workload_spec(TWL), t_fleet_statics(TGRID),
                         tst, tprov)
    assert ttab.counts.shape == (14, TGRID.n_cells, 3, 4)
    _assert_tables_close(
        {k: v.numpy() for k, v in ttab._asdict().items()},
        {k: np.asarray(v) for k, v in jtab._asdict().items()})

    scene, ex = _t_episode(TCFG, tprov, tst, collect_obs=True)
    replay, _ = _t_episode(TCFG, ttab, tst)
    for name in DECISIONS:
        np.testing.assert_array_equal(scene[name], replay[name],
                                      err_msg=name)
    np.testing.assert_allclose(scene["pred_acc"], replay["pred_acc"],
                               atol=1e-6, rtol=0)
    # collect_obs records camera 0's tables, the materialized leaves
    assert torch.equal(ex["obs"]["counts"], ttab.counts)
    assert scene["k_send"].sum() > 0
