"""The port's threefry streams (repro_torch.scene.prng) against
jax.random with jax_threefry_partitionable=True.

Keys, raw bits, uniform and randint are bit-equal for the shapes the
scene and render draw. normal goes through erfinv: the port evaluates
the same Giles polynomial as XLA, but log1p can round differently in
the last bit, so normal samples are held to 2e-6 absolute (samples of
magnitude up to ~5; the largest difference seen is 4 float32 ulps).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.scene import prng  # noqa: E402

SHAPES = [(22,), (22, 2), (22, 4), (3, 2), (64, 64, 3)]


def _keys(seed, n=6):
    data = np.arange(n) * 7 + 3
    jk = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(seed), jnp.asarray(data))
    tk = prng.fold_in(prng.PRNGKey(seed), torch.as_tensor(data))
    return jk, tk


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(got.numpy().dtype))


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_keys_fold_in_split(seed):
    _eq(prng.PRNGKey(seed), jax.random.PRNGKey(seed))
    jk, tk = _keys(seed)
    _eq(tk, jk)
    _eq(prng.split(tk, 8), jax.vmap(lambda k: jax.random.split(k, 8))(jk))
    _eq(prng.split(tk), jax.vmap(jax.random.split)(jk))
    frames = jnp.arange(jk.shape[0]) * 1000
    _eq(prng.fold_in(tk, torch.as_tensor(np.array(frames))),
        jax.vmap(jax.random.fold_in)(jk, frames))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits_and_uniform_equal(shape):
    jk, tk = _keys(1)
    _eq(prng.random_bits(tk, shape),
        jax.vmap(lambda k: jax.random.bits(k, shape))(jk))
    _eq(prng.uniform(tk, shape),
        jax.vmap(lambda k: jax.random.uniform(k, shape))(jk))
    _eq(prng.uniform(tk, shape, 2.5, 5.5),
        jax.vmap(lambda k: jax.random.uniform(
            k, shape, minval=2.5, maxval=5.5))(jk))


def test_uniform_vector_bounds_equal():
    jk, tk = _keys(2)
    lo, hi = np.array([15.0, 10.0]), np.array([135.0, 65.0])
    _eq(prng.uniform(tk, (3, 2), torch.tensor(lo, dtype=torch.float32),
                     torch.tensor(hi, dtype=torch.float32)),
        jax.vmap(lambda k: jax.random.uniform(
            k, (3, 2), minval=jnp.asarray(lo, jnp.float32),
            maxval=jnp.asarray(hi, jnp.float32)))(jk))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("hi", [3, 14])
def test_randint_equal(shape, hi):
    jk, tk = _keys(3)
    _eq(prng.randint(tk, shape, 0, hi),
        jax.vmap(lambda k: jax.random.randint(k, shape, 0, hi))(jk))


@pytest.mark.parametrize("shape", SHAPES)
def test_normal_close(shape):
    jk, tk = _keys(4)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape))(jk))
    got = prng.normal(tk, shape).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    assert np.mean(got == want) > 0.95
