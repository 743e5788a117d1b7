"""The port's vision half of the model zoo against the JAX package on the
same numpy-seeded weights and images, at the SMOKE configs: the configs
and shapes, the window helpers of Swin's attention, `layers.layernorm`
in bf16, the ViT's VisionConfig forms (`vit_forward` with impl "xla" and
"flash", `vit_loss`) and Swin (`swin_forward`, `swin_loss`), each with
weights carried across by `vision_params_from_numpy`.

The reference runs jitted with XLA's `xla_allow_excess_precision` off,
so every bf16 op rounds as written, as PyTorch's do.

Tolerances: float32 1e-4 on logits of order 1 (sums in another order;
measured at most 4.8e-7 for the ViTs and 3.3e-7 for Swin); bf16 2e-2
absolute on logits of order 1, the reference's own (measured at most
1.2e-2, one or two bf16 ulps at 1-2.3: the bf16 patch-embed products
reduce in another order than XLA's convolution); the losses 1e-5
(float32, measured 2.2e-7) and 2e-2 (bf16, measured 2.4e-3) relative.
Window partitioning, the shifted-window mask, the relative-position
index and the effective window are exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import swin as jswin  # noqa: E402
from repro.models import vit as jvit  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import swin as tswin  # noqa: E402
from repro_torch.models import vit as tvit  # noqa: E402
from torch_zoo_weights import (  # noqa: E402
    DIFFUSION_ARCHS,
    VISION_ARCHS,
    numpy_weights,
    port_init,
    smoke,
)

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_REL = {"float32": 1e-5, "bfloat16": 2e-2}
VITS = ["vit-s16", "vit-b16", "vit-h14"]
# Swin variants: the SMOKE config (no shifted block: one block a stage),
# two blocks a stage (odd blocks shift by half the window), and window
# 3 at 64 px: 3 does not divide the 16 x 16 stage-1 map, whose
# effective window is 8 (shifted by 4); stage 2's 8 x 8 map is no larger
# than its window, so no shift there
SWIN_VARIANTS = {
    "smoke": {},
    "shifted": {"depths": (2, 2)},
    "effective-window": {"depths": (2, 2), "window": 3, "img_res": 64},
}
B = 2


def _jit(fn):
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False})


def _jcfg(cfg):
    """The reference's config of a port config (same fields; jnp dtype)."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    fields["dtype"] = getattr(jnp, str(cfg.dtype)[6:])
    return jconfigs.VisionConfig(**fields)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(cfg, seed=0):
    """(reference params, port params) of one numpy draw."""
    tree = numpy_weights(cfg, seed)
    jdt = getattr(jnp, str(cfg.dtype)[6:])
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype=jdt), tree)
    return jp, tvit.vision_params_from_numpy(tree, cfg.dtype, device="cpu")


def _images(cfg, seed=1):
    return np.random.default_rng(seed).uniform(
        0, 1, (B, cfg.img_res, cfg.img_res, 3)).astype(np.float32)


def _labels(cfg, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.n_classes, B)


def _max_err(a, b) -> float:
    return float(np.abs(a - b).max())


# ---------------------------------------------------------------------------
# configs and shapes
# ---------------------------------------------------------------------------

def _fields(cfg) -> dict:
    out = dataclasses.asdict(cfg)
    out["dtype"] = str(np.dtype(cfg.dtype)) if not isinstance(
        cfg.dtype, torch.dtype) else str(cfg.dtype)[6:]
    return out


@pytest.mark.parametrize("arch", VISION_ARCHS + DIFFUSION_ARCHS)
def test_configs_match_reference(arch):
    for get_t, get_j in ((tconfigs.get_config, jconfigs.get_config),
                         (tconfigs.get_smoke_config,
                          jconfigs.get_smoke_config)):
        t, j = get_t(arch), get_j(arch)
        assert type(t).__name__ == type(j).__name__
        assert _fields(t) == _fields(j)
        assert t.family == j.family
        if t.family == "diffusion":
            assert t.is_mmdit == j.is_mmdit


def test_shapes_and_registry_match_reference():
    for name in ("LM_SHAPES", "VISION_SHAPES", "DIFFUSION_SHAPES"):
        assert ([dataclasses.asdict(s) for s in getattr(tshapes, name)]
                == [dataclasses.asdict(s) for s in getattr(jshapes, name)])
    assert set(tshapes.FAMILY_SHAPES) == set(jshapes.FAMILY_SHAPES)
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert set(tconfigs.ASSIGNED_ARCHS) <= set(tconfigs.list_archs())
    for arch in VISION_ARCHS + DIFFUSION_ARCHS:
        cfg = tconfigs.get_config(arch)
        assert ([s.name for s in tshapes.shapes_for(cfg)]
                == [s.name for s in jshapes.shapes_for(
                    jconfigs.get_config(arch))])
    assert tshapes.get_shape(tconfigs.get_config("flux-dev"),
                             "gen_fast").img_res == 512
    with pytest.raises(KeyError):
        tshapes.get_shape(tconfigs.get_config("vit-h14"), "gen_fast")


def _layout(tree):
    return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype).replace(
        "torch.", "")), tree)


@pytest.mark.parametrize("arch", VISION_ARCHS)
def test_init_layout_matches_reference(arch):
    """The port's init gives the reference's tree: the same keys, lists,
    stacked shapes and dtype (bf16)."""
    cfg = smoke(arch, torch.bfloat16)
    jinit = jswin.swin_init if cfg.swin else jvit.vit_init
    want = jax.eval_shape(lambda k: jinit(k, _jcfg(cfg)),
                          jax.random.PRNGKey(0))
    assert _layout(port_init(cfg, np.random.default_rng(0))) == _layout(want)


def test_vision_params_from_numpy_keeps_layout():
    cfg = smoke("swin-b", torch.bfloat16)
    tree = numpy_weights(cfg)
    got = tvit.vision_params_from_numpy(tree, torch.bfloat16, device="cpu")
    assert isinstance(got["stages"], list)
    assert isinstance(got["stages"][0]["blocks"], list)
    leaves = jax.tree.leaves(got)
    assert all(x.dtype == torch.bfloat16 and x.device.type == "cpu"
               for x in leaves)
    assert len(leaves) == len(jax.tree.leaves(tree))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_matches_reference(dtype):
    """bf16 input: the port normalises in float32 and casts back, as the
    reference does (it used to normalise in bf16); float32 stays bit for
    bit the formula the detector's path reads."""
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 1, (4, 7, 96)) * 3 + 5).astype(np.float32)
    scale = (1 + rng.normal(0, 0.1, 96)).astype(np.float32)
    bias = rng.normal(0, 0.1, 96).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jp = {"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)}
    tp = {"scale": torch.as_tensor(scale).to(tdt),
          "bias": torch.as_tensor(bias).to(tdt)}
    want = _jit(jlayers.layernorm)(jp, jnp.asarray(x, jdt))
    got = tlayers.layernorm(tp, torch.as_tensor(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "bfloat16":
        # bit-equal (normalising in bf16 was off by up to 3.1e-2, 8 ulps)
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:
        # XLA's rsqrt and fused products: measured 7.2e-7 on outputs
        # of order 2
        assert _max_err(_f32(got), _f32(want)) <= 2e-6
        xt = torch.as_tensor(x)
        mu = xt.mean(-1, keepdim=True)
        var = torch.square(xt - mu).mean(-1, keepdim=True)
        old = (xt - mu) * torch.rsqrt(var + 1e-6) * tp["scale"] + tp["bias"]
        assert torch.equal(got, old)


@pytest.mark.parametrize("dtype", DTYPES)
def test_modulated_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(4)
    x = (rng.normal(0, 2, (2, 5, 64)) + 1).astype(np.float32)
    sh = rng.normal(0, 0.5, (2, 1, 64)).astype(np.float32)
    sc = rng.normal(0, 0.5, (2, 1, 64)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    want = _jit(lambda a, b, c: jlayers.modulated_layernorm({}, a, b, c))(
        *(jnp.asarray(v, jdt) for v in (x, sh, sc)))
    got = tlayers.modulated_layernorm(
        {}, *(torch.as_tensor(v).to(tdt) for v in (x, sh, sc)))
    assert got.dtype == tdt
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_f32(got), _f32(want))
    else:
        assert _max_err(_f32(got), _f32(want)) <= 2e-6


# ---------------------------------------------------------------------------
# window helpers (exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,window", [(8, 8, 2), (12, 6, 3), (14, 14, 7),
                                        (24, 24, 12)])
def test_window_partition_round_trip(h, w, window):
    x = np.random.default_rng(h * w).normal(0, 1, (2, h, w, 5)).astype(
        np.float32)
    got = tattn.window_partition(torch.as_tensor(x), window)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jattn.window_partition(jnp.asarray(x),
                                                       window)))
    back = tattn.window_unpartition(got, window, h, w)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("h,w,window,shift", [(8, 8, 2, 1), (16, 16, 8, 4),
                                              (14, 14, 7, 3),
                                              (12, 24, 6, 3),
                                              (48, 48, 12, 6)])
def test_shifted_window_mask_exact(h, w, window, shift):
    want = np.asarray(jax.jit(jattn.shifted_window_mask, static_argnums=(
        0, 1, 2, 3))(h, w, window, shift))
    got = tattn.shifted_window_mask(h, w, window, shift).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_rel_position_index_and_effective_window_exact():
    for window in range(1, tswin.MAX_WINDOW + 1):
        np.testing.assert_array_equal(tswin._rel_position_index(window),
                                      jswin._rel_position_index(window))
    assert tswin.MAX_WINDOW == jswin.MAX_WINDOW
    for m in range(1, 129):
        for pref in (2, 3, 5, 7, 12):
            assert (tswin._effective_window(m, pref)
                    == jswin._effective_window(m, pref)), (m, pref)
    # Swin-B at 384 px: window 7 does not divide the 96 x 96 stage-1 map
    assert tswin._effective_window(96, 7) == 12


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shift", [0, 1])
def test_window_attention_matches_reference(dtype, shift):
    """Biased window attention; impl="flash" runs the same plain path,
    as the reference's does."""
    rng = np.random.default_rng(5 + shift)
    h = w = 4
    window, heads, c = 2, 2, 16
    x = rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
    p = {n: {"w": rng.normal(0, 0.25, (c, c)).astype(np.float32),
             "b": rng.normal(0, 0.05, c).astype(np.float32)}
         for n in ("wq", "wk", "wv", "wo")}
    rel = rng.normal(0, 0.5, (heads, window ** 2, window ** 2)).astype(
        np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    jmask = (jattn.shifted_window_mask(h, w, window, shift) if shift
             else None)
    tmask = (tattn.shifted_window_mask(h, w, window, shift) if shift
             else None)

    def jfn(p, x, rel):
        return jattn.window_attention(
            p, jattn.window_partition(x, window), n_heads=heads,
            rel_bias=rel, mask=jmask)

    want = _jit(jfn)(jax.tree.map(lambda a: jnp.asarray(a, jdt), p),
                     jnp.asarray(x, jdt), jnp.asarray(rel, jdt))
    tp = jax.tree.map(lambda a: torch.as_tensor(a).to(tdt), p)
    wins = tattn.window_partition(torch.as_tensor(x).to(tdt), window)
    outs = [tattn.window_attention(tp, wins, n_heads=heads,
                                   rel_bias=torch.as_tensor(rel).to(tdt),
                                   mask=tmask, impl=impl)
            for impl in ("xla", "flash")]
    assert torch.equal(outs[0], outs[1])
    assert _max_err(_f32(outs[0]), _f32(want)) <= TOL[dtype]


# ---------------------------------------------------------------------------
# ViT (VisionConfig forms)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(a, d) for a in VITS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def vit_case(request):
    arch, dtype = request.param
    cfg = smoke(arch, getattr(torch, dtype))
    jp, tp = _pair(cfg)
    return {"arch": arch, "dtype": dtype, "cfg": cfg, "jcfg": _jcfg(cfg),
            "jp": jp, "tp": tp, "img": _images(cfg), "labels": _labels(cfg)}


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_vit_forward_matches_reference(vit_case, impl):
    """vit_forward(params, cfg, images, impl=...) against the reference's
    (its impl="flash": the Pallas kernel in interpret mode)."""
    c = vit_case
    want = _jit(lambda p, x: jvit.vit_forward(p, c["jcfg"], x, impl=impl))(
        c["jp"], jnp.asarray(c["img"]))
    with torch.no_grad():
        got = tvit.vit_forward(c["tp"], c["cfg"], torch.as_tensor(c["img"]),
                               impl=impl)
    assert got.dtype == c["cfg"].dtype
    assert got.shape == (B, c["cfg"].n_classes)
    assert _max_err(_f32(got), _f32(want)) <= TOL[c["dtype"]]


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_vit_loss_matches_reference(vit_case, smoothing):
    c = vit_case
    want = float(_jit(lambda p, x, y: jvit.vit_loss(
        p, c["jcfg"], x, y, label_smoothing=smoothing))(
        c["jp"], jnp.asarray(c["img"]), jnp.asarray(c["labels"])))
    with torch.no_grad():
        got = float(tvit.vit_loss(c["tp"], c["cfg"],
                                  torch.as_tensor(c["img"]),
                                  torch.as_tensor(c["labels"]),
                                  label_smoothing=smoothing))
    assert abs(got - want) <= LOSS_REL[c["dtype"]] * abs(want)


def test_vit_block_init_and_both_forms():
    """vit_block_init draws one layer of the cfg's widths; in float32 the
    cfg form and the detector's keyword form compute the same logits."""
    cfg = smoke("vit-s16", torch.float32)
    blk = tvit.vit_block_init(np.random.default_rng(0), cfg, device="cpu")
    assert blk["attn"]["wq"]["w"].shape == (cfg.d_model, cfg.d_model)
    assert blk["mlp"]["up"]["w"].shape == (cfg.d_model, cfg.d_ff)
    tp = tvit.vit_init(np.random.default_rng(0), cfg, device="cpu",
                       img_res=2 * cfg.img_res)
    assert tp["pos_embed"].shape[1] == (2 * cfg.img_res // cfg.patch) ** 2 + 1
    img = torch.as_tensor(_images(cfg))
    with torch.no_grad():
        a = tvit.vit_forward(tp, cfg, img)
        b = tvit.vit_forward(tp, img, patch=cfg.patch, n_heads=cfg.n_heads)
    assert torch.equal(a, b)
    with pytest.raises(TypeError):
        tvit.vit_forward(tp, img)


# ---------------------------------------------------------------------------
# Swin
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module",
                params=[(v, d) for v in SWIN_VARIANTS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def swin_case(request):
    variant, dtype = request.param
    cfg = smoke("swin-b", getattr(torch, dtype), **SWIN_VARIANTS[variant])
    jp, tp = _pair(cfg)
    return {"dtype": dtype, "cfg": cfg, "jcfg": _jcfg(cfg), "jp": jp,
            "tp": tp, "img": _images(cfg), "labels": _labels(cfg)}


def test_swin_forward_matches_reference(swin_case):
    c = swin_case
    want = _jit(lambda p, x: jswin.swin_forward(p, c["jcfg"], x))(
        c["jp"], jnp.asarray(c["img"]))
    with torch.no_grad():
        got = tswin.swin_forward(c["tp"], c["cfg"],
                                 torch.as_tensor(c["img"]))
    assert got.dtype == c["cfg"].dtype
    assert got.shape == (B, c["cfg"].n_classes)
    assert _max_err(_f32(got), _f32(want)) <= TOL[c["dtype"]]


def test_swin_loss_matches_reference(swin_case):
    c = swin_case
    want = float(_jit(lambda p, x, y: jswin.swin_loss(p, c["jcfg"], x, y))(
        c["jp"], jnp.asarray(c["img"]), jnp.asarray(c["labels"])))
    with torch.no_grad():
        got = float(tswin.swin_loss(c["tp"], c["cfg"],
                                    torch.as_tensor(c["img"]),
                                    torch.as_tensor(c["labels"])))
    assert abs(got - want) <= LOSS_REL[c["dtype"]] * abs(want)
