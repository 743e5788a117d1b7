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
|CPU|), the CPU tests' tolerances against the reference, the ViTs'
with impl="flash" too (the kernel on the card, its plain version on the
CPU).

At full width and depth (weights from seeded CUDA generators, compared
only with other runs on the card; zero-initialised adaLN linears and
final projections drawn at 0.02, else DiT and the MMDiT are the
identity):

- ViT-H/14, ViT-B/16, ViT-S/16: float32 at batch 8, impl="flash"
  launches flash_attention once per layer, "xla" none, both `dense`
  once for each linear large enough (192, 24 and 0 a forward), the
  logits
  within the flash kernel's float32 tolerance (3e-5) scaled to their
  largest magnitude; bf16 at serve_b128 (224 px, batch 128), the same
  launches, flash vs xla within 0.1 relative RMS (24-32 layers of bf16
  rounding random-walk to ~1e-2; a wrong path is off by O(1));
- Swin-B in bf16 at serve_b128 and at 384 px, DiT-L/2 (bf16 against
  float32 within 0.1 relative RMS, then dit_sample at gen_fast: 512 px,
  batch 16, 4 steps, the learned pos_embed resized) and Flux-dev
  (rf_sample at gen_fast, at most 70 GiB of the card's memory at full
  depth) launch no kernel and give finite outputs of their shapes;
- one block of DiT-L/2 and a Flux double and single block (256 image
  tokens, 128 text tokens), float32, card vs CPU within 1e-4 of max(1,
  max |CPU|).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.models import diffusion, dit, mmdit, swin, vit  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    cast_floats,
    full_float32,
    params_from_numpy,
)
from repro_torch.scene import prng  # noqa: E402
from repro_torch.train.optim import tree_map  # noqa: E402
from torch_zoo_weights import (  # noqa: E402
    DIFFUSION_ARCHS,
    VISION_ARCHS,
    numpy_weights,
    perturb_numpy,
    smoke,
    smoke_outputs,
)
from torch_kernel_inputs import vit_dense_launches  # noqa: E402

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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("arch", VITS)
def test_smoke_vit_flash_card_matches_cpu(cuda, arch, dtype, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    cfg = smoke(arch, dtype)
    tree = numpy_weights(cfg)
    with torch.no_grad(), full_float32():
        want = smoke_outputs(cfg, params_from_numpy(tree, dtype, "cpu"),
                             "cpu", vit_impl="flash")
        got, c = _counted(lambda: smoke_outputs(
            cfg, params_from_numpy(tree, dtype, cuda), cuda,
            vit_impl="flash"))
    assert c == {"flash_attention": cfg.n_layers}
    for g, w in zip(got, want):
        assert _err(g, w) <= TOL[dtype]


def _rel_rms(got, want) -> float:
    d = (got.float() - want.float()).square().mean().sqrt()
    return float(d / want.float().square().mean().sqrt())


def _wake_zero_init(params, gen) -> None:
    """Draw a DiT / MMDiT tree's zero-initialised adaLN linears and final
    projections from N(0, 0.02) in place."""
    for k, v in params.items():
        if isinstance(v, dict):
            if "w" in v and ("ada" in k or k == "final_proj"):
                v["w"].normal_(0.0, 0.02, generator=gen)
            else:
                _wake_zero_init(v, gen)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", VITS)
def test_full_width_vit_flash_matches_xla(cuda, arch):
    cfg32 = dataclasses.replace(get_config(arch), dtype=torch.float32)
    res = cfg32.img_res
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = vit.vit_init(gen, cfg32, device=cuda)
    img = torch.rand(8, res, res, 3, generator=gen, device=cuda)
    flash = {"flash_attention": cfg32.n_layers}
    # dense takes the float32 linears of at least DENSE_MIN_ROWS rows and
    # DENSE_MIN_MACS multiply-adds, once each (ViT-H/14: all six a layer,
    # ViT-B/16: the MLP's two, ViT-S/16: none)
    linears = vit_dense_launches(cfg32, img.shape[0])
    dense = {"dense": linears} if linears else {}
    with torch.no_grad(), full_float32():
        fl, c = _counted(lambda: vit.vit_forward(params, cfg32, img,
                                                 impl="flash"))
        assert c == flash | dense
        xl, c = _counted(lambda: vit.vit_forward(params, cfg32, img,
                                                 impl="xla"))
        assert c == dense
    assert bool(torch.isfinite(fl).all())
    assert float((fl - xl).abs().max()) <= 3e-5 * float(xl.abs().max())
    cfg = get_config(arch)
    params = cast_floats(params, cfg.dtype)
    imgs = torch.rand(128, res, res, 3, generator=gen, device=cuda)
    with torch.no_grad():
        fl, c = _counted(lambda: vit.vit_forward(params, cfg, imgs,
                                                 impl="flash"))
        assert c == flash
        xl, c = _counted(lambda: vit.vit_forward(params, cfg, imgs,
                                                 impl="xla"))
        assert c == {}
    assert bool(torch.isfinite(fl).all()) and _rel_rms(fl, xl) <= 0.1


@pytest.mark.requires_cuda
def test_full_width_swin_b_bf16(cuda):
    """Swin-B at serve_b128 and at 384 px, where window 7 divides no
    stage's map."""
    cfg = get_config("swin-b")
    gen = torch.Generator(device=cuda).manual_seed(1)
    params = swin.swin_init(gen, cfg, device=cuda)
    for batch, res in ((128, cfg.img_res), (8, 384)):
        imgs = torch.rand(batch, res, res, 3, generator=gen, device=cuda)
        with torch.no_grad():
            out, c = _counted(lambda: swin.swin_forward(params, cfg, imgs))
        assert c == {}
        assert out.shape == (batch, cfg.n_classes)
        assert bool(torch.isfinite(out).all())


@pytest.mark.requires_cuda
def test_full_width_dit_l2(cuda):
    """A float32 forward at 256 px (latent 32, its trained grid) against
    the bf16 forward of the same weights, then dit_sample in bf16 at
    gen_fast (latent 64: the learned 16 x 16 pos_embed resized)."""
    cfg = get_config("dit-l2")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(2)
    params = dit.dit_init(gen, cfg32, device=cuda)
    _wake_zero_init(params, gen)
    r0 = cfg.img_res // 8
    lat = torch.randn(2, r0, r0, cfg.latent_channels, generator=gen,
                      device=cuda)
    t = torch.tensor([10.0, 700.0], device=cuda)
    y = torch.tensor([3, cfg.n_classes], device=cuda)
    with torch.no_grad():
        with full_float32():
            want = dit.dit_forward(params, cfg32, lat, t, y)
        params = cast_floats(params, cfg.dtype)
        got = dit.dit_forward(params, cfg, lat, t, y)
        assert bool(torch.isfinite(got).all()) and _rel_rms(got, want) <= 0.1
        x, c = _counted(lambda: diffusion.dit_sample(
            params, cfg, prng.PRNGKey(0, device=cuda), batch=16, n_steps=4,
            latent_res=64))
    assert c == {}
    assert x.shape == (16, 64, 64, cfg.latent_channels)
    assert bool(torch.isfinite(x).all())


@pytest.mark.requires_cuda
def test_full_width_flux_dev_sample(cuda):
    """rf_sample at gen_fast: 1,024 image tokens and 128 text tokens from
    seeded embeddings, 4 steps, under 70 GiB at full depth."""
    cfg = get_config("flux-dev")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = mmdit.mmdit_init(gen, cfg, device=cuda)
    _wake_zero_init(params, gen)
    txt = torch.randn(16, mmdit.TXT_TOKENS, cfg.cond_dim, generator=gen,
                      device=cuda)
    with torch.no_grad():
        x, c = _counted(lambda: diffusion.rf_sample(
            params, cfg, prng.PRNGKey(3, device=cuda), batch=16, n_steps=4,
            txt_emb=txt, latent_res=64))
    assert c == {}
    assert x.shape == (16, 64, 64, cfg.latent_channels)
    assert bool(torch.isfinite(x).all())
    assert torch.cuda.max_memory_allocated() <= 70 * 2 ** 30


def _dit_block(rng):
    cfg = dataclasses.replace(get_config("dit-l2"), dtype=torch.float32)
    return (dit.dit_block_init(rng, cfg, device="cpu"),
            lambda p, x, c: dit.dit_block(p, x, c, cfg),
            [(1, 256, cfg.d_model), (1, cfg.d_model)])


def _flux_block(kind):
    def make(rng):
        cfg = dataclasses.replace(get_config("flux-dev"),
                                  dtype=torch.float32)
        d, tt = cfg.d_model, mmdit.TXT_TOKENS
        if kind == "double":
            return (mmdit.double_block_init(rng, cfg, device="cpu"),
                    lambda p, i, t, c: mmdit.double_block(p, i, t, c, cfg),
                    [(1, 256, d), (1, tt, d), (1, d)])
        return (mmdit.single_block_init(rng, cfg, device="cpu"),
                lambda p, x, c: mmdit.single_block(p, x, c, cfg),
                [(1, 256 + tt, d), (1, d)])
    return make


@pytest.mark.requires_cuda
@pytest.mark.parametrize("make", [_dit_block, _flux_block("double"),
                                  _flux_block("single")],
                         ids=["dit-l2", "flux-dev-double",
                              "flux-dev-single"])
def test_full_width_block_card_matches_cpu(cuda, make):
    """One full-width block, float32, batch 1, weights drawn by numpy
    (perturbed as trained ones would be)."""
    rng = np.random.default_rng(0)
    tree, fn, shapes = make(rng)
    p = params_from_numpy(perturb_numpy(tree, rng), torch.float32, "cpu")
    args = [torch.as_tensor(rng.normal(0, 1, s).astype(np.float32))
            for s in shapes]
    with torch.no_grad(), full_float32():
        want = fn(p, *args)
        got = fn(tree_map(lambda t: t.to(cuda), p),
                 *(a.to(cuda) for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all()) and _err(g, w) <= 1e-4
