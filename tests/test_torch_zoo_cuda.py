"""The vision and diffusion half of the model zoo on the card
(`requires_cuda`: skipped without one; the flash kernel has no CPU
mode). Imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_zoo_cuda.py

At the SMOKE configs (weights drawn by numpy, the same under any
PyTorch): impl="flash" inside `vit_forward` launches flash_attention
once per layer and nothing else, and agrees with impl="xla" within 1e-4
in float32 (the kernel's split-TF32 products and online softmax, 3e-5
on attention outputs of order 1, through two layers to logits of order
1); every family's forward, loss and sampler (2 steps) on the card
agree with the CPU within 1e-4 (float32) and 2e-2 (bf16) of max(1, max
|CPU|), the CPU tests' tolerances against the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.models import swin, vit  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    full_float32,
    params_from_numpy,
)
from repro_torch.train.optim import tree_map  # noqa: E402
from torch_zoo_weights import (  # noqa: E402
    DIFFUSION_ARCHS,
    VISION_ARCHS,
    numpy_weights,
    smoke,
    smoke_outputs,
)

VITS = ["vit-s16", "vit-b16", "vit-h14"]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


def _counted(fn):
    """(fn(), the kernels it launched {name: n}) but threefry, which
    launches once for each of scene/prng.py's draws on the card
    (tests/test_torch_prng_cuda.py holds it), not on the model's path."""
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _lib.launch_counts().items()
                 if v and k != "threefry"}


def _err(got, want) -> float:
    return float((got.cpu().float() - want.float()).abs().max()
                 / max(1.0, float(want.float().abs().max())))


def _images(cfg):
    return torch.as_tensor(np.random.default_rng(1).uniform(
        0, 1, (2, cfg.img_res, cfg.img_res, 3)).astype(np.float32))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", VITS)
def test_vit_flash_launches_once_per_layer(cuda, arch):
    cfg = smoke(arch, torch.float32)
    tree = numpy_weights(cfg)
    p = params_from_numpy(tree, cfg.dtype, cuda)
    img = _images(cfg)
    with torch.no_grad(), full_float32():
        got, c = _counted(lambda: vit.vit_forward(p, cfg, img.to(cuda),
                                                  impl="flash"))
        assert c == {"flash_attention": cfg.n_layers}
        xla, c = _counted(lambda: vit.vit_forward(p, cfg, img.to(cuda),
                                                  impl="xla"))
        assert c == {}
        cpu = vit.vit_forward(params_from_numpy(tree, cfg.dtype, "cpu"),
                              cfg, img)
    assert _err(got, xla.cpu()) <= 1e-4
    assert _err(got, cpu) <= 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("arch", VISION_ARCHS + DIFFUSION_ARCHS)
def test_smoke_config_card_matches_cpu(cuda, arch, dtype):
    cfg = smoke(arch, dtype)
    tree = numpy_weights(cfg)
    with torch.no_grad(), full_float32():
        want = smoke_outputs(cfg, params_from_numpy(tree, dtype, "cpu"),
                             "cpu")
        got, c = _counted(lambda: smoke_outputs(
            cfg, params_from_numpy(tree, dtype, cuda), cuda))
    assert c == {}          # the plain paths, as the reference's
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and bool(torch.isfinite(g).all())
        assert _err(g, w) <= TOL[dtype]


@pytest.mark.requires_cuda
def test_swin_block_shifted_full_width(cuda):
    """A Swin-B stage-3 block (14 x 14 map, dim 512, 16 heads, window 7,
    shifted by 3) in float32, card vs CPU."""
    rng = np.random.default_rng(0)
    p = swin.swin_block_init(rng, 512, 16, 7, device="cpu")
    x = torch.as_tensor(rng.normal(0, 1, (1, 14, 14, 512)).astype(
        np.float32))
    idx = torch.as_tensor(swin._rel_position_index(7))
    kw = dict(n_heads=16, window=7, shift=3)
    with torch.no_grad(), full_float32():
        want = swin.swin_block(p, x, rel_index=idx, **kw)
        got = swin.swin_block(tree_map(lambda t: t.to(cuda), p), x.to(cuda),
                              rel_index=idx.to(cuda), **kw)
    assert _err(got, want) <= 1e-4
