"""The detector's Swin backbone on the card (`requires_cuda`: skipped
without one). Imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_swin_detector_cuda.py

crop_patchify's kernel at Swin's patch 4 and width 128 against its plain
version (1e-4 absolute on tokens of order 1: the split-TF32 product on
the tensor cores against torch.matmul, as for patch 16); the smoke Swin
detector on the card against the CPU (1e-4: float32 GEMMs of cuBLAS
against the CPU's, sums in other orders); and a forward after the first
copies nothing to the device and never synchronises (its constants are
made once).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import DetectorConfig, VisionConfig
from repro_torch.kernels import _lib
from repro_torch.kernels.crop_patchify.ops import (
    crop_patchify_batch,
    crop_patchify_plain,
)
from repro_torch.models import detector as det
from repro_torch.models.layers import full_float32
from repro_torch.scene.render import object_colors, render_background
from torch_kernel_inputs import patchify_inputs, t

SWIN = DetectorConfig(
    name="swin-smoke", img_res=64, patch=4, max_boxes=8, fpn_dim=32,
    swin=VisionConfig(name="swin-smoke", img_res=64, patch=4, n_layers=6,
                      d_model=32, n_heads=1, d_ff=128, swin=True, window=4,
                      depths=(2, 2, 2), dims=(32, 64, 128),
                      dtype=torch.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


# (F, K, object slots): ragged row tiles at Swin-B's 3,136 patches a
# crop, ownership in one and two words
CASES = [(3, 5, 22), (2, 7, 40)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_crop_patchify_patch4_on_card(cuda, case):
    f, k, m = case
    pos, size, kind, oid, wins, _, _ = patchify_inputs(f, k, 128, seed=m,
                                                       shared=False, m=m)
    rng = np.random.default_rng(m)
    w = rng.normal(0, 1 / np.sqrt(48), (48, 128)).astype(np.float32)
    b = rng.normal(0, 0.01, 128).astype(np.float32)
    noise = (0.05 * rng.normal(0, 1, (f, 224, 224, 3))).astype(np.float32)
    pos, size = t(pos).to(cuda), t(size).to(cuda)
    strips = [x.contiguous() for x in (pos[..., 0], pos[..., 1],
                                       size[..., 0], size[..., 1])]
    colors = object_colors(t(kind).to(cuda), t(oid).to(cuda)).contiguous()
    bgn = (render_background(224, cuda)[None] + t(noise).to(cuda))
    args = (*strips, colors, t(wins).to(cuda), bgn.contiguous(),
            t(w).to(cuda), t(b).to(cuda))
    _lib.reset_launch_counts()
    got = crop_patchify_batch(*args, res=224, patch=4, min_visible=0.25)
    assert _lib.launch_counts()["crop_patchify"] == 1
    assert got.shape == (f, k, 3136, 128)
    with full_float32():
        want = crop_patchify_plain(*args, res=224, patch=4,
                                   min_visible=0.25)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


@pytest.mark.requires_cuda
def test_swin_detector_on_card(cuda):
    params = det.detector_init(np.random.default_rng(3), SWIN, "cpu")
    tokens = torch.randn(6, 256, 32, generator=torch.Generator()
                         .manual_seed(3))
    on_card = det.params_from_numpy(params, cuda)
    tok_card = tokens.to(cuda)
    with full_float32(), torch.no_grad():
        want = det.detector_neck_feats_tokens(params, SWIN, tokens)
        got = det.detector_neck_feats_tokens(on_card, SWIN, tok_card)
        torch.cuda.synchronize()
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            again = det.detector_neck_feats_tokens(on_card, SWIN, tok_card)
            torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    assert torch.equal(again, got)
    names = [e.name for e in prof.events()]
    assert not [n for n in names if "HtoD" in n or "DtoH" in n]
    syncs = [n for n in names if n.startswith("cuda") and "Synchronize" in n
             and n != "cudaDeviceSynchronize"]
    assert syncs == []
