"""The port's attention stack against the JAX package on the same seeded
numpy inputs: the flash-attention API (plain version on the CPU)
against the Pallas kernel in interpret mode, sdpa / GQA / RoPE, the ViT
encoder with impl="flash" and impl="xla", the image-side ViT entries
and the position-embedding resize.

Tolerances: attention outputs 3e-5 in float32 (softmax sums and products
in another order than XLA's) and 2e-2 in bfloat16 (one bf16 rounding of
the output); ViT features 2e-5 after the smoke model's layers; RoPE
angles and the resized position embedding 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as j_flash,
)
from repro.models import attention as jattn  # noqa: E402
from repro.models import detector as jdet  # noqa: E402
from repro.models import vit as jvit  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention,
)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import detector as tdet  # noqa: E402
from repro_torch.models import vit as tvit  # noqa: E402

JCFG = get_smoke_config("madeye-approx")

# (B, Sq, Sk, Hq, Hkv, D, causal, dtype): tests/test_kernels.py's cases
FLASH_CASES = [
    (1, 64, 64, 2, 2, 32, False, "float32"),
    (2, 128, 128, 4, 2, 64, True, "float32"),
    (1, 100, 100, 2, 1, 24, True, "float32"),      # ragged + MQA
    (1, 1, 96, 4, 4, 16, False, "float32"),        # decode shape
    (2, 72, 136, 3, 1, 48, False, "float32"),      # Sq != Sk
    (1, 64, 64, 2, 2, 32, False, "bfloat16"),
    (1, 256, 256, 2, 2, 128, True, "float32"),
    (1, 64, 64, 2, 1, 192, True, "float32"),       # MLA's 192-wide heads
]


def _qkv(b, sq, sk, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, sq, hq, d)).astype(np.float32),
            rng.normal(0, 1, (b, sk, hkv, d)).astype(np.float32),
            rng.normal(0, 1, (b, sk, hkv, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same values as JAX arrays and CPU tensors of `dtype`."""
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tx


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[str(c) for c in FLASH_CASES])
def test_flash_attention_matches_jax(case):
    b, sq, sk, hq, hkv, d, causal, dtype = case
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, sq, sk, hq, hkv, d, sq + d),
                                       dtype)
    want = j_flash(jq, jk, jv, causal=causal)
    _lib.reset_launch_counts()
    got = flash_attention(tq, tk, tv, causal=causal)
    assert _lib.launch_counts()["flash_attention"] == 0   # plain on CPU
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_flash_attention_q_offset_matches_jax():
    """A query block placed at q_offset into a longer key sequence."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 8, 32, 4, 2, 16, 7),
                                       "float32")
    want = j_flash(jq, jk, jv, causal=True, q_offset=24)
    got = flash_attention(tq, tk, tv, causal=True, q_offset=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_flash_attention_rejects_bad_shapes():
    q, k, v = (torch.zeros(1, 4, 3, 8), torch.zeros(1, 4, 2, 8),
               torch.zeros(1, 4, 2, 8))
    with pytest.raises(ValueError):
        flash_attention(q, k, v)                 # 3 heads over 2 kv heads
    with pytest.raises(ValueError):
        flash_attention(q[:, :, :2], k, v[..., :4])


def test_rope_matches_jax():
    want = jattn.rope_frequencies(16, 40, theta=500.0)
    got = tattn.rope_frequencies(16, 40, theta=500.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    x = np.random.default_rng(0).normal(0, 1, (2, 40, 3, 16)).astype(
        np.float32)
    np.testing.assert_allclose(
        tattn.apply_rope(torch.as_tensor(x), got).numpy(),
        np.asarray(jattn.apply_rope(jnp.asarray(x), want)), atol=1e-5)


@pytest.mark.parametrize("sq,causal,q_offset", [(24, False, 0),
                                                (24, True, 0),
                                                (2048, True, 0),
                                                (8, True, 16)])
def test_sdpa_matches_jax(sq, causal, q_offset):
    """GQA (4 query heads over 2 kv heads), causal masks, q_offset, and
    the chunked path at CHUNKED_THRESHOLD."""
    sk = sq + q_offset
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, sq, sk, 4, 2, 8, sq),
                                       "float32")
    for impl in ("xla", "flash"):
        want = jattn.sdpa(jq, jk, jv, causal=causal, q_offset=q_offset,
                          impl=impl)
        got = tattn.sdpa(tq, tk, tv, causal=causal, q_offset=q_offset,
                         impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=3e-5, err_msg=impl)


def test_sdpa_bias_matches_jax():
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 9, 9, 4, 4, 8, 3),
                                       "float32")
    bias = np.random.default_rng(4).normal(0, 1, (1, 4, 1, 9, 9)).astype(
        np.float32)
    want = jattn.sdpa(jq, jk, jv, bias=jnp.asarray(bias))
    got = tattn.sdpa(tq, tk, tv, bias=torch.as_tensor(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_gqa_attention_matches_jax(impl):
    """GQA block with RoPE and a causal mask, the reference's weights."""
    rng = np.random.default_rng(2)
    shapes = {"wq": (32, 32), "wk": (32, 16), "wv": (32, 16),
              "wo": (32, 32)}
    tree = {n: {"w": rng.normal(0, 0.2, s).astype(np.float32),
                "b": rng.normal(0, 0.1, s[1]).astype(np.float32)}
            for n, s in shapes.items()}
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tdet.params_from_numpy(tree)
    x = rng.normal(0, 1, (2, 20, 32)).astype(np.float32)
    angles = jattn.rope_frequencies(8, 64)
    want = jattn.gqa_attention(jp, jnp.asarray(x), n_heads=4, n_kv_heads=2,
                               angles=angles, causal=True, impl=impl)
    got = tattn.gqa_attention(tp, torch.as_tensor(x), n_heads=4,
                              n_kv_heads=2,
                              angles=tattn.rope_frequencies(8, 64),
                              causal=True, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_gqa_init_layout():
    jp = jattn.gqa_init(jax.random.PRNGKey(0), 32, 4, 2, head_dim=16)
    tp = tattn.gqa_init(torch.Generator().manual_seed(0), 32, 4, 2,
                        head_dim=16)
    assert (jax.tree.map(lambda x: tuple(x.shape), jp)
            == jax.tree.map(lambda x: tuple(x.shape), tp))


@pytest.fixture(scope="module")
def vit_weights():
    """Seeded weights in the reference's layout (the port's init, whose
    layout test_torch_detector pins), as numpy, handed to both sides."""
    fresh = tvit.vit_init(torch.Generator().manual_seed(5),
                          img_res=JCFG.img_res, patch=JCFG.patch,
                          n_layers=JCFG.n_layers, d_model=JCFG.d_model,
                          n_heads=JCFG.n_heads, d_ff=JCFG.d_ff)
    tree = jax.tree.map(lambda x: x.numpy(), fresh)
    # non-zero biases and norms, so every parameter is exercised
    rng = np.random.default_rng(6)
    tree = jax.tree.map(
        lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32), tree)
    return (jax.tree.map(jnp.asarray, tree), tdet.params_from_numpy(tree))


def _tokens(b, n_patches, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1, (b, n_patches, JCFG.d_model)).astype(np.float32)


def test_vit_features_tokens_flash_matches_jax(vit_weights):
    """The detector backbone with impl="flash" and impl="xla" against the
    JAX backbone with impl="flash" (Pallas, interpret mode)."""
    jp, tp = vit_weights
    x = _tokens(3, (JCFG.img_res // JCFG.patch) ** 2, 0)
    bcfg = jdet._backbone_cfg(JCFG)
    want = np.asarray(jvit.vit_features_tokens(jp, bcfg, jnp.asarray(x),
                                               impl="flash"))
    for impl in ("flash", "xla"):
        got = tvit.vit_features_tokens(tp, torch.as_tensor(x),
                                       n_heads=JCFG.n_heads, impl=impl)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5,
                                   err_msg=impl)


@pytest.mark.parametrize("n_patches", [25, 9])
def test_vit_encode_tokens_resizes_pos_embed_like_jax(vit_weights,
                                                      n_patches):
    """Tokens of another patch count than pos_embed's 16: the grid part
    is resized (up to 5x5, down to 3x3) as jax.image.resize does."""
    jp, tp = vit_weights
    x = _tokens(2, n_patches, n_patches)
    want = jvit.vit_encode_tokens(jp, jdet._backbone_cfg(JCFG),
                                  jnp.asarray(x), impl="flash")
    got = tvit.vit_encode_tokens(tp, torch.as_tensor(x),
                                 n_heads=JCFG.n_heads, impl="flash")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("g_old,g_new", [(4, 7), (4, 2), (8, 5), (5, 8),
                                         (14, 16), (14, 4)])
def test_interp_pos_embed_matches_jax(g_old, g_new):
    pos = np.random.default_rng(g_old * 10 + g_new).normal(
        0, 1, (1, 1 + g_old * g_old, 6)).astype(np.float32)
    want = jvit._interp_pos_embed(jnp.asarray(pos), g_new * g_new)
    got = tvit._interp_pos_embed(torch.as_tensor(pos), g_new * g_new)
    assert got.shape == (1, 1 + g_new * g_new, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_vit_image_entries_match_jax(vit_weights):
    """vit_embed / vit_encode / vit_features / vit_forward on images."""
    jp, tp = vit_weights
    bcfg = jdet._backbone_cfg(JCFG)
    img = np.random.default_rng(9).uniform(
        0, 1, (2, JCFG.img_res, JCFG.img_res, 3)).astype(np.float32)
    ji, ti = jnp.asarray(img), torch.as_tensor(img)
    kw = dict(patch=JCFG.patch, n_heads=JCFG.n_heads)
    np.testing.assert_allclose(
        tvit.vit_embed(tp, ti, patch=JCFG.patch).numpy(),
        np.asarray(jvit.vit_embed(jp, bcfg, ji)), atol=1e-5)
    for name in ("vit_encode", "vit_features", "vit_forward"):
        want = getattr(jvit, name)(jp, bcfg, ji, impl="flash")
        got = getattr(tvit, name)(tp, ti, impl="flash", **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-5, err_msg=name)
