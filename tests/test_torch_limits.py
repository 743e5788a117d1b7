"""Shapes past the card kernels' old limits, on the CPU, against the JAX
package: crop rendering and patch tokens with more than 32 object slots
(ownership in several 32-lane words), a scene episode on the 200-cell
7.5-degree grid (cell sets of four 64-bit words on the card) and a
detector episode on a 40-slot scene. The oracle pass at 160 slots is in
test_torch_oracle_pass.py, flash attention at 192-wide heads in
test_torch_attention.py, the shape-search model at 200 cells in
test_torch_shape_search.py; the kernels themselves at these shapes in
test_torch_kernels_cuda.py (card only).

Tolerances: decisions (`chosen`, `frames_sent`, `explored`, `order`,
`zooms`, `sent`) exact; rendered pixels one float32 ulp (6e-8, see the
renderer test); patch tokens 1e-5 absolute
(a 768-term float32 product in another order than XLA's, as in
test_torch_kernels.py); per-step accuracy 1e-6 (float32 means of equal
grades, as in test_torch_fleet_e2e.py).
"""
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
from repro.fleet.runner import save_detector_params  # noqa: E402
from repro.kernels.crop_patchify.ops import (  # noqa: E402
    crop_patchify as j_crop_patchify,
)
from repro.models.detector import detector_init  # noqa: E402
from repro.scene_jax.render import render_fleet_crops  # noqa: E402
from repro.scene_jax.scene import SceneSpec as JSceneSpec  # noqa: E402
from repro_torch.fleet.api import FleetRunSpec as TSpec  # noqa: E402
from repro_torch.fleet.api import run_fleet as t_run_fleet  # noqa: E402
from repro_torch.kernels.crop_patchify.ops import (  # noqa: E402
    MAX_OBJECTS,
    SMEM_LIMIT,
    crop_patchify,
    kernel_shared_bytes,
    render_crops_plain,
)
from repro_torch.scene.render import (  # noqa: E402
    object_colors,
    render_background,
)
from repro_torch.scene.scene import SceneSpec as TSceneSpec  # noqa: E402
from torch_kernel_inputs import patchify_inputs, t  # noqa: E402

GRID_200 = {"pan_step": 7.5, "tilt_step": 7.5}      # 20 x 10 cells


@pytest.mark.parametrize("m", [40, 70, 300])
def test_render_crops_past_one_word_match_ref(m):
    """Ownership over ceil(M / 32) words paints every pixel as the
    reference renderer's masked argmax does (300 slots: past the
    kernel's 256, which the plain version takes too). Every pixel within
    one float32 ulp: XLA rounds the vmapped reference's colour and
    background arithmetic otherwise, while two objects' colours differ by
    far more, so the owners are the same (at M <= 32 the packed
    reference is bit-equal, test_torch_kernels.py)."""
    pos, size, kind, oid, wins, _, _ = patchify_inputs(2, 4, 8, seed=m,
                                                       shared=False, m=m)
    want = render_fleet_crops(jnp.asarray(pos), jnp.asarray(size),
                              jnp.asarray(kind), jnp.asarray(oid),
                              jnp.asarray(wins), res=64, min_visible=0.25)
    tpos, tsize = t(pos), t(size)
    got = render_crops_plain(
        tpos[..., 0], tpos[..., 1], tsize[..., 0], tsize[..., 1],
        object_colors(t(kind), t(oid)), t(wins),
        render_background(64)[None].expand(2, 64, 64, 3), res=64,
        min_visible=0.25)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=6e-8)
    painted = (np.abs(got - render_background(64).numpy()) > 1e-6).any(-1)
    assert painted.mean() > 0.01


@pytest.mark.parametrize("m", [40, 70])
def test_crop_patchify_tokens_past_one_word_match_pallas(m):
    """Tokens against the JAX package's crop_patchify_batch kernel in
    interpret mode (ownership from an iota over any slot count)."""
    pos, size, kind, oid, wins, pe, noise = patchify_inputs(
        2, 3, 48, seed=m + 1, shared=False, m=m)
    want = j_crop_patchify(
        *(jnp.asarray(x) for x in (pos, size, kind, oid, wins)),
        {n: jnp.asarray(v) for n, v in pe.items()}, patch=16, res=64,
        min_visible=0.25, noise=jnp.asarray(noise), use_kernel=True,
        interpret=True)
    got = crop_patchify(t(pos), t(size), t(kind), t(oid), t(wins),
                        {n: t(v) for n, v in pe.items()}, patch=16, res=64,
                        min_visible=0.25, noise=t(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_crop_patchify_kernel_budget_covers_256_slots():
    """The kernel's shared memory (mirrored by kernel_shared_bytes) fits
    256 slots at the full-width detector's 224 px, patch 16, D = 192,
    and the main path's 22 slots."""
    for m in (22, 40, 70, 129, MAX_OBJECTS):
        assert kernel_shared_bytes(m, 224, 16, 192, 1152) <= SMEM_LIMIT
    assert MAX_OBJECTS == 256


def test_scene_episode_on_200_cell_grid_matches_jax():
    s = JSpec(provider="scene", n_cameras=4, n_steps=4, seed=3,
              budget={"fps": 4.0}, grid=GRID_200).to_json()
    want = j_run_fleet(JSpec.from_json(s))
    got = t_run_fleet(TSpec.from_json(s), device="cpu")
    assert got.chosen == want.chosen
    assert got.frames_sent == want.frames_sent
    for name in ("explored", "order", "zooms", "sent"):
        np.testing.assert_array_equal(getattr(got.out, name).numpy(),
                                      np.asarray(getattr(want.out, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.acc_per_step, want.acc_per_step,
                               atol=1e-6, rtol=0)
    # cells past the two-word sets' 128 are explored, in shapes of
    # several cells
    assert bool(got.out.explored[..., 128:].any())
    assert int(got.out.explored.sum(-1).max()) > 1


def test_detector_episode_with_40_slots_matches_jax(tmp_path):
    params = detector_init(jax.random.PRNGKey(1),
                           get_smoke_config("madeye-approx"))
    path = save_detector_params(str(tmp_path / "det.npz"), params)
    kw = dict(provider="detector", n_cameras=2, n_steps=3, seed=2,
              shortlist_k=18)
    want = j_run_fleet(JSpec(**kw, provider_kwargs={
        "det_params": path, "spec": JSceneSpec(max_people=24,
                                               max_cars=16)}))
    got = t_run_fleet(TSpec(**kw, provider_kwargs={
        "det_params": path, "spec": TSceneSpec(max_people=24,
                                               max_cars=16)}),
        device="cpu")
    assert got.chosen == want.chosen
    assert got.frames_sent == want.frames_sent
    for name in ("explored", "order", "zooms", "sent"):
        np.testing.assert_array_equal(getattr(got.out, name).numpy(),
                                      np.asarray(getattr(want.out, name)),
                                      err_msg=name)
    np.testing.assert_allclose(got.acc_per_step, want.acc_per_step,
                               atol=1e-6, rtol=0)
