"""The threefry kernel (csrc/threefry.cu) against scene/prng.py's plain
version on the card (`requires_cuda`: skipped without one; the kernel
has no CPU mode). Imports no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_prng_cuda.py

Every draw is bit-equal: keys, bits, uniform (scalar and tensor bounds),
randint and normal, at the scene's shapes, the render noise's, a
diffusion-sized draw and sizes off the block width, over keys with 0, 1
and 2 leading dims and a strided slice. Each prng call on the card is
one launch; a scene step and its noise launch 19.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.scene import prng  # noqa: E402
from repro_torch.scene import render  # noqa: E402
from repro_torch.scene import scene as sc  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


def _keys(dev, layout: str) -> torch.Tensor:
    """Keys with 0, 1 or 2 leading dims, or a slice ks[:, 3] of [F, 8, 2]."""
    rows = prng.fold_in_plain(prng.PRNGKey(11, dev),
                              torch.arange(64, device=dev))
    if layout == "0d":
        return rows[5]
    if layout == "1d":
        return rows
    if layout == "2d":
        return rows[:32].reshape(4, 8, 2)
    return prng.split_plain(rows, 8)[:, 3]                  # [64, 2] strided


def _launch_once(fn, *args):
    before = _lib.launch_counts()["threefry"]
    out = fn(*args)
    assert _lib.launch_counts()["threefry"] - before == 1
    return out


def _bit_equal(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_cuda
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    bad = int((got != want).sum())
    assert bad == 0, f"{bad} of {got.numel()} elements differ"


LAYOUTS = ["0d", "1d", "2d", "slice"]
SCENE_SHAPES = [(22,), (22, 2), (22, 4)]
# off the 256-thread block: a ragged last block, and a draw below a warp
ODD_SHAPES = [(1000,), (257, 3), (5,)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", LAYOUTS)
def test_fold_in_and_split_bit_equal(cuda, layout):
    key = _keys(cuda, layout)
    batch = key.shape[:-1]
    _bit_equal(_launch_once(prng.fold_in, key, 7),
               prng.fold_in_plain(key, 7))
    _bit_equal(_launch_once(prng.fold_in, key, -3),
               prng.fold_in_plain(key, -3))
    data = torch.arange(max(1, batch.numel()), device=cuda).reshape(
        batch) * 1000 + 2 ** 33
    _bit_equal(_launch_once(prng.fold_in, key, data),
               prng.fold_in_plain(key, data))
    frame = torch.tensor(9, device=cuda)
    _bit_equal(_launch_once(prng.fold_in, key, frame),
               prng.fold_in_plain(key, frame))
    for num in (2, 4, 8):
        _bit_equal(_launch_once(prng.split, key, num),
                   prng.split_plain(key, num))


@pytest.mark.requires_cuda
def test_fold_in_one_key_over_data(cuda):
    key = prng.PRNGKey(3, cuda)
    data = torch.arange(64, device=cuda) * 7 + 1
    _bit_equal(_launch_once(prng.fold_in, key, data),
               prng.fold_in_plain(key, data))
    data = data[::2].reshape(4, 8)
    _bit_equal(_launch_once(prng.fold_in, key, data),
               prng.fold_in_plain(key, data))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shape", SCENE_SHAPES + ODD_SHAPES)
def test_draws_bit_equal(cuda, layout, shape):
    key = _keys(cuda, layout)
    _bit_equal(_launch_once(prng.random_bits, key, shape),
               prng.random_bits_plain(key, shape))
    for lo, hi in ((0.0, 1.0), (2.5, 5.5), (1.1, 1.9), (-3, 7)):
        _bit_equal(_launch_once(prng.uniform, key, shape, lo, hi),
                   prng.uniform_plain(key, shape, lo, hi))
    for span in (3, 4, 50257):
        _bit_equal(_launch_once(prng.randint, key, shape, 0, span),
                   prng.randint_plain(key, shape, 0, span))
    _bit_equal(_launch_once(prng.randint, key, shape, -5, 9),
               prng.randint_plain(key, shape, -5, 9))
    _bit_equal(_launch_once(prng.normal, key, shape),
               prng.normal_plain(key, shape))


@pytest.mark.requires_cuda
def test_uniform_tensor_bounds_bit_equal(cuda):
    key = _keys(cuda, "1d")
    lo = torch.tensor([15.0, 10.0], device=cuda)
    hi = torch.tensor([135.0, 65.0], device=cuda)
    _bit_equal(_launch_once(prng.uniform, key, (8, 2), lo, hi),
               prng.uniform_plain(key, (8, 2), lo, hi))
    lo0 = torch.tensor(0.5, device=cuda)
    _bit_equal(_launch_once(prng.uniform, key, (22,), lo0, 2.0),
               prng.uniform_plain(key, (22,), lo0, 2.0))


@pytest.mark.requires_cuda
def test_noise_draw_bit_equal(cuda):
    """The render noise: [64, 224, 224, 3] normals (9.6M) over 64 keys."""
    keys = _keys(cuda, "1d")
    _bit_equal(_launch_once(prng.normal, keys, (224, 224, 3)),
               prng.normal_plain(keys, (224, 224, 3)))


@pytest.mark.requires_cuda
def test_diffusion_sized_draws_bit_equal(cuda):
    """models/diffusion.py: timesteps and noise over one key, a DiT
    latent batch [16, 64, 64, 4]."""
    kt, ke = prng.split(prng.PRNGKey(4, cuda), 2)
    _bit_equal(_launch_once(prng.randint, kt, (16,), 0, 1000),
               prng.randint_plain(kt, (16,), 0, 1000))
    _bit_equal(_launch_once(prng.normal, ke, (16, 64, 64, 4)),
               prng.normal_plain(ke, (16, 64, 64, 4)))


@pytest.mark.requires_cuda
def test_empty_draws_launch_nothing(cuda):
    key = _keys(cuda, "1d")
    before = _lib.launch_counts()["threefry"]
    assert prng.normal(key, (0, 3)).shape == (64, 0, 3)
    assert prng.split(key[:0], 4).shape == (0, 4, 2)
    assert _lib.launch_counts()["threefry"] == before


@pytest.mark.requires_cuda
def test_scene_step_and_noise_launch_once_a_draw(cuda, monkeypatch):
    """One advance_scene (stride 1) and render_noise at 64 cameras: 16
    draws in the scene (fold_in; split x 3; randint x 4; normal x 5;
    uniform x 3) and 3 in the noise (fold_in x 2, normal), each one
    launch, and the state and noise bit-equal to the plain version's."""
    spec = sc.SceneSpec()
    params, rng = sc.scene_fleet_params(spec, 64, device=cuda)
    state0 = sc.init_scene(spec, params, rng)
    step = torch.full((64,), 5, dtype=torch.int64, device=cuda)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    state = sc.advance_scene(spec, params, rng, state0, step, 1)
    scene_launches = _lib.launch_counts()["threefry"]
    noise = render.render_noise(rng, step * 1, 224)
    counts = _lib.launch_counts()
    assert scene_launches == 16
    assert counts["threefry"] == 19
    assert sum(counts.values()) == 19
    monkeypatch.setattr(prng, "_on_card", lambda key: False)
    want = sc.advance_scene(spec, params, rng, state0, step, 1)
    want_noise = render.render_noise(rng, step * 1, 224)
    assert _lib.launch_counts()["threefry"] == 19
    for got_t, want_t in zip(state, want):
        _bit_equal(got_t, want_t)
    _bit_equal(noise, want_noise)
