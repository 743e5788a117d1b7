"""The plain versions of the port's three kernels against the JAX
package.

Every wrapper takes its plain PyTorch version when its tensors lie on
the CPU; those plain versions are held against the JAX references (and
the neighbor-score Pallas kernel in interpret mode) on the same seeded
numpy inputs. The CUDA kernels against their plain versions:
test_torch_kernels_cuda.py and tools/kernel_table.py.

Tolerances: counts, candidate masks and rendered pixels are exact.
Sums are float32 taken in another order than XLA's (areas, moments,
neighbor scores: 1e-5 relative; patch tokens, a 768-term product at the
smoke width's 48: 1e-5 absolute on values of order 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.cell_rasterize.ref import cell_rasterize_ref  # noqa: E402
from repro.kernels.crop_patchify.ref import (  # noqa: E402
    _render_crops_packed,
    crop_patchify_ref,
)
from repro.kernels.neighbor_score import ops as jns  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.cell_rasterize.ops import (  # noqa: E402
    cell_rasterize,
)
from repro_torch.kernels.crop_patchify.ops import (  # noqa: E402
    crop_patchify,
    render_crops_plain,
)
from repro_torch.kernels.neighbor_score.ops import (  # noqa: E402
    neighbor_scores,
)
from repro_torch.scene.render import (  # noqa: E402
    object_colors,
    render_background,
)
from torch_kernel_inputs import (  # noqa: E402
    GEO,
    neighbor_inputs,
    patchify_inputs,
    rasterize_inputs,
    t,
)


# ---------------------------------------------------------------------------
# neighbor_score
# ---------------------------------------------------------------------------

def _port_neighbor(shape, has, cent, head):
    return neighbor_scores(
        t(shape), t(has), t(cent), t(head), t(GEO["d_center"]),
        t(GEO["overlap"]), t(GEO["cell_x"]), t(GEO["cell_y"]),
        t(GEO["neighbor8"]))


@pytest.mark.parametrize("b,seed", [(1, 0), (4, 1), (4, 2)])
def test_neighbor_scores_match_ref(b, seed):
    shape, has, cent, head = neighbor_inputs(b, seed)
    want, want_cand = jns.neighbor_scores(
        jnp.asarray(shape), jnp.asarray(has), jnp.asarray(cent),
        jnp.asarray(head), *(jnp.asarray(GEO[k]) for k in (
            "d_center", "overlap", "cell_x", "cell_y", "neighbor8")))
    got, cand = _port_neighbor(shape, has, cent, head)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(want_cand))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_neighbor_scores_match_pallas_interpret():
    shape, has, cent, head = neighbor_inputs(3, 9)
    want, _ = jns.neighbor_scores(
        jnp.asarray(shape), jnp.asarray(has), jnp.asarray(cent),
        jnp.asarray(head), *(jnp.asarray(GEO[k]) for k in (
            "d_center", "overlap", "cell_x", "cell_y", "neighbor8")),
        use_kernel=True, interpret=True)
    got, _ = _port_neighbor(shape, has, cent, head)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_neighbor_wrapper_counts_no_cpu_launch():
    """On CPU tensors the wrapper takes the plain version and launches
    nothing."""
    shape, has, cent, head = neighbor_inputs(2, 3)
    _lib.reset_launch_counts()
    _port_neighbor(shape, has, cent, head)
    assert _lib.launch_counts()["neighbor_score"] == 0


# ---------------------------------------------------------------------------
# cell_rasterize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f,p,n_moment,seed", [(1, 1, 1, 0), (3, 8, 4, 1),
                                               (4, 8, 8, 2)])
def test_cell_rasterize_matches_ref(f, p, n_moment, seed):
    args = rasterize_inputs(f, p, seed)
    want = cell_rasterize_ref(*(jnp.asarray(x) for x in args),
                              min_visible=0.25, n_moment=n_moment)
    got = cell_rasterize(*(t(x) for x in args), min_visible=0.25,
                         n_moment=n_moment)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].sum() > 0
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# crop_patchify
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f,k,shared", [(2, 6, False), (3, 4, True)])
def test_render_crops_bit_equal_packed_ref(f, k, shared):
    pos, size, kind, oid, wins, _, noise = patchify_inputs(
        f, k, 8, seed=10 + f, shared=shared)
    want = _render_crops_packed(jnp.asarray(pos), jnp.asarray(size),
                                jnp.asarray(kind), jnp.asarray(oid),
                                jnp.asarray(wins), jnp.asarray(noise),
                                res=64, min_visible=0.25)
    tpos, tsize = t(pos), t(size)
    colors = object_colors(t(kind), t(oid))
    bgn = render_background(64)[None] + t(noise)
    got = render_crops_plain(tpos[..., 0], tpos[..., 1], tsize[..., 0],
                             tsize[..., 1], colors, t(wins), bgn, res=64,
                             min_visible=0.25)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("f,k,d,shared,block_k",
                         [(2, 6, 48, False, 3), (3, 4, 16, True, None)])
def test_crop_patchify_tokens_match_ref(f, k, d, shared, block_k):
    pos, size, kind, oid, wins, pe, noise = patchify_inputs(
        f, k, d, seed=20 + k, shared=shared)
    want = crop_patchify_ref(
        jnp.asarray(pos), jnp.asarray(size), jnp.asarray(kind),
        jnp.asarray(oid), jnp.asarray(wins),
        {n: jnp.asarray(v) for n, v in pe.items()}, patch=16, res=64,
        min_visible=0.25, noise=jnp.asarray(noise))
    got = crop_patchify(t(pos), t(size), t(kind), t(oid), t(wins),
                        {n: t(v) for n, v in pe.items()}, patch=16, res=64,
                        min_visible=0.25, noise=t(noise), block_k=block_k)
    assert got.shape == (f, k, 16, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
