"""The port's CUDA kernels against their plain PyTorch versions, on
the card (`requires_cuda`: skipped without one; CUDA kernels have no CPU
mode). Imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Tolerances: counts exact; neighbor scores, areas and moments 1e-5
(float32 sums in another order); patch tokens 1e-4 absolute on values of
order 1 (the token product's FMAs vs torch.matmul). chip_smoke.py runs
the same checks at the main path's full-width shapes.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.cell_rasterize.ops import (  # noqa: E402
    cell_rasterize,
    cell_rasterize_plain,
)
from repro_torch.kernels.crop_patchify.ops import (  # noqa: E402
    crop_patchify_batch,
    crop_patchify_plain,
)
from repro_torch.kernels.neighbor_score.ops import (  # noqa: E402
    neighbor_score_batch,
    neighbor_score_plain,
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


@pytest.mark.requires_cuda
def test_wrappers_reject_bad_input(cuda):
    args = [t(x).to(cuda) for x in rasterize_inputs(2, 2, 0)]
    with pytest.raises(TypeError):
        cell_rasterize(*args[:4], args[4].double(), *args[5:])
    with pytest.raises(ValueError):
        cell_rasterize(args[0].t(), *args[1:])
