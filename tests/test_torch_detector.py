"""The port's ViT detector against the JAX package with the same weights:
JAX `detector_init` params carried across by `params_from_numpy` (and
by the shared `.npz` checkpoint format).

Tolerances: float32 products and convolutions summed in another order
than XLA's — layers to 1e-5 (relative where values reach ~10),
detection scores and boxes to 1e-4 after
the whole forward; the top-k selection (which cells the boxes come
from) is equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.fleet.runner import save_detector_params  # noqa: E402
from repro.models import detector as jdet  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import vit as jvit  # noqa: E402
from repro_torch.configs import MADEYE_APPROX_SMOKE  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fleet.runner import load_detector_params  # noqa: E402
from repro_torch.models import detector as tdet  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import vit as tvit  # noqa: E402

JCFG = get_smoke_config("madeye-approx")


def tn(x):
    return torch.as_tensor(np.asarray(x).copy())


@pytest.fixture(scope="module")
def weights():
    jp = jdet.detector_init(jax.random.PRNGKey(3), JCFG)
    return jp, tdet.params_from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(b, seed=0):
    rng = np.random.default_rng(seed)
    g = (JCFG.img_res // JCFG.patch) ** 2
    return rng.normal(0, 1, (b, g, JCFG.d_model)).astype(np.float32)


def test_configs_match():
    for name in ("img_res", "patch", "n_layers", "d_model", "n_heads",
                 "d_ff", "n_classes", "max_boxes", "fpn_dim"):
        assert getattr(MADEYE_APPROX_SMOKE, name) == getattr(JCFG, name)
        assert (getattr(get_config("madeye-approx"), name)
                == getattr(j_get_config("madeye-approx"), name))


@pytest.mark.parametrize("padding,stride,k", [("SAME", 1, 3), ("SAME", 1, 1),
                                              ("VALID", 16, 16)])
def test_conv2d_and_layernorm(padding, stride, k):
    rng = np.random.default_rng(k)
    x = rng.normal(0, 1, (2, 32, 32, 5)).astype(np.float32)
    p = {"w": rng.normal(0, 0.2, (k, k, 5, 7)).astype(np.float32),
         "b": rng.normal(0, 0.1, 7).astype(np.float32)}
    want = jlayers.conv2d({n: jnp.asarray(v) for n, v in p.items()},
                          jnp.asarray(x), stride=stride, padding=padding)
    got = tlayers.conv2d({n: tn(v) for n, v in p.items()}, tn(x),
                         stride=stride, padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    ln = {"scale": rng.normal(1, 0.1, 5).astype(np.float32),
          "bias": rng.normal(0, 0.1, 5).astype(np.float32)}
    np.testing.assert_allclose(
        tlayers.layernorm({n: tn(v) for n, v in ln.items()}, tn(x)).numpy(),
        np.asarray(jlayers.layernorm({n: jnp.asarray(v)
                                      for n, v in ln.items()},
                                     jnp.asarray(x))), atol=1e-5)


def test_vit_encode_tokens_match(weights):
    jp, tp = weights
    x = _tokens(3, seed=1)
    bcfg = jdet._backbone_cfg(JCFG)
    want = jvit.vit_encode_tokens(jp["backbone"]["vit"], bcfg,
                                  jnp.asarray(x))
    got = tvit.vit_encode_tokens(tp["backbone"]["vit"], tn(x),
                                 n_heads=JCFG.n_heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _cells(boxes, g):
    """The top-k cell each decoded box came from (cx, cy in-cell)."""
    b = np.asarray(boxes)
    return (np.floor(b[..., 1] * g) * g + np.floor(b[..., 0] * g)).astype(
        int)


@pytest.mark.parametrize("b,seed", [(4, 0), (6, 5)])
def test_detector_forward_tokens_match(weights, b, seed):
    jp, tp = weights
    x = _tokens(b, seed)
    want = jdet.detector_forward_tokens(jp, JCFG, jnp.asarray(x))
    got = tdet.detector_forward_tokens(tp, MADEYE_APPROX_SMOKE, tn(x))
    g = JCFG.img_res // JCFG.patch
    np.testing.assert_array_equal(_cells(got.boxes.numpy(), g),
                                  _cells(want.boxes, g))
    for name in ("scores", "boxes", "class_probs"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-4, err_msg=name)


def test_load_detector_params_reads_jax_npz(weights, tmp_path):
    jp, tp = weights
    path = save_detector_params(str(tmp_path / "det.npz"), jp)
    loaded = load_detector_params(path)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(tp))
    for keypath, leaf in flat_j:
        node = loaded
        for k in keypath:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    x = tn(_tokens(2, 3))
    a = tdet.detector_forward_tokens(loaded, MADEYE_APPROX_SMOKE, x)
    c = tdet.detector_forward_tokens(tp, MADEYE_APPROX_SMOKE, x)
    for u, v in zip(a, c):
        np.testing.assert_array_equal(u.numpy(), v.numpy())


def test_port_init_has_reference_layout(weights):
    _, tp = weights
    fresh = tdet.detector_init(torch.Generator().manual_seed(0),
                               MADEYE_APPROX_SMOKE)
    shapes = jax.tree.map(lambda x: tuple(x.shape), tp)
    assert jax.tree.map(lambda x: tuple(x.shape), fresh) == shapes


def test_numpy_generator_init(weights):
    """detector_init from a numpy Generator: the reference's layout, the
    same weights from the same seed (numpy's draws, not PyTorch's), each
    weight a truncated normal within 2 std (the patch embed's std is
    sqrt(2 / fan_in)), the first leaf the documented draw."""
    _, tp = weights
    a = tdet.detector_init(np.random.default_rng(7), MADEYE_APPROX_SMOKE)
    b = tdet.detector_init(np.random.default_rng(7), MADEYE_APPROX_SMOKE)
    assert jax.tree.map(lambda x: tuple(x.shape), a) == jax.tree.map(
        lambda x: tuple(x.shape), tp)
    for u, v in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert u.dtype == torch.float32
        assert torch.equal(u, v)
    w = a["backbone"]["vit"]["patch_embed"]["w"]
    std = float(np.sqrt(2.0 / (w.shape[0] * w.shape[1] * w.shape[2])))
    assert float(w.abs().max()) <= 2.0 * std * (1 + 1e-6)
    rng = np.random.default_rng(7)
    z = rng.standard_normal(tuple(w.shape))
    while (np.abs(z) > 2.0).any():
        out = np.abs(z) > 2.0
        z[out] = rng.standard_normal(int(out.sum()))
    np.testing.assert_array_equal(w.numpy(), (z * std).astype(np.float32))


def test_pos_embed_mismatch_raises(weights):
    """Tokens that form no square grid raise; a square grid of another
    size resizes pos_embed (held against JAX in test_torch_attention)."""
    _, tp = weights
    with pytest.raises(ValueError):
        tvit.vit_encode_tokens(tp["backbone"]["vit"],
                               torch.zeros(1, 10, JCFG.d_model),
                               n_heads=JCFG.n_heads)
    out = tvit.vit_encode_tokens(tp["backbone"]["vit"],
                                 torch.zeros(1, 9, JCFG.d_model),
                                 n_heads=JCFG.n_heads)
    assert out.shape == (1, 10, JCFG.d_model)
