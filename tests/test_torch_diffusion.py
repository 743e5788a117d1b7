"""The port's diffusion half of the model zoo against the JAX package on
the same numpy-seeded weights, latents and keys, at the SMOKE configs:
DiT (`dit_forward`, on and off its trained grid), the MMDiT
(`mmdit_forward`), the training losses (`dit_train_loss`,
`rf_train_loss`) and the samplers (`dit_sample`: DDIM at eta 0;
`rf_sample`: Euler), with weights carried across by
`diffusion_params_from_numpy`.

The reference runs jitted with XLA's `xla_allow_excess_precision` off,
so every bf16 op rounds as written, as PyTorch's do. The same integer
seed makes the same key on both sides (`prng.PRNGKey` is
`jax.random.PRNGKey`'s raw threefry key), so both draw the same
timesteps and noise (normal draws within a few ulps).

Tolerances, each on max |port - reference| over max(1, max |reference|)
(the samplers' latents reach ~8e2, DDIM dividing by sqrt(alpha_bar)):
float32 1e-4 (measured at most 8.3e-7 for the forwards, 6.9e-7 for
the samplers); bf16 2e-2, the reference's own (measured at most 5.8e-3
for the forwards, under one bf16 ulp of their largest outputs, and
3.9e-3 for the samplers); the losses 1e-5 (float32, measured 1.2e-6)
and 2e-2 (bf16, measured 8.2e-4) relative. The sampler's integer
timesteps are exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import diffusion as jdiff  # noqa: E402
from repro.models import dit as jdit  # noqa: E402
from repro.models import mmdit as jmmdit  # noqa: E402
from repro_torch.models import diffusion as tdiff  # noqa: E402
from repro_torch.models import dit as tdit  # noqa: E402
from repro_torch.models import mmdit as tmmdit  # noqa: E402
from repro_torch.scene import prng  # noqa: E402
from torch_zoo_weights import (  # noqa: E402
    DIFFUSION_ARCHS,
    numpy_weights,
    port_init,
    smoke,
)

DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
LOSS_REL = {"float32": 1e-5, "bfloat16": 2e-2}
B = 2
TXT = 8          # text tokens of the forward and loss cases
# DiT grids: (img_res of the config, latent side fed): its trained grid,
# the learned 2 x 2 pos_embed resized up to 4 x 4, a 4 x 4 one resized
# down to 2 x 2 (antialiased) and up by a non-integer factor to 6 x 6
DIT_GRIDS = {"trained": (32, 4), "up": (32, 8), "down": (64, 4),
             "up-1.5x": (64, 12)}


def _jit(fn):
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False})


def _jcfg(cfg):
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    fields["dtype"] = getattr(jnp, str(cfg.dtype)[6:])
    return jbase.DiffusionConfig(**fields)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_err(got, want) -> float:
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / max(1.0, np.abs(w).max()))


def _pair(cfg, seed=0):
    tree = numpy_weights(cfg, seed)
    jdt = getattr(jnp, str(cfg.dtype)[6:])
    return (jax.tree.map(lambda a: jnp.asarray(a, dtype=jdt), tree),
            tdiff.diffusion_params_from_numpy(tree, cfg.dtype, device="cpu"))


def _latents(cfg, r, seed=1):
    return np.random.default_rng(seed).normal(
        0, 1, (B, r, r, cfg.latent_channels)).astype(np.float32)


def _txt(cfg, seed=3, n=TXT):
    return np.random.default_rng(seed).normal(
        0, 1, (B, n, cfg.cond_dim)).astype(np.float32)


@pytest.fixture(scope="module", params=[(a, d) for a in DIFFUSION_ARCHS
                                        for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def case(request):
    arch, dtype = request.param
    cfg = smoke(arch, getattr(torch, dtype))
    jp, tp = _pair(cfg)
    return {"arch": arch, "dtype": dtype, "cfg": cfg, "jcfg": _jcfg(cfg),
            "jp": jp, "tp": tp}


# ---------------------------------------------------------------------------
# layout, embeddings, schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DIFFUSION_ARCHS)
def test_init_layout_matches_reference(arch):
    """The port's init gives the reference's tree (keys, stacked shapes,
    bf16), the adaLN linears and final projection zero."""
    cfg = smoke(arch, torch.bfloat16)
    jinit = jmmdit.mmdit_init if cfg.is_mmdit else jdit.dit_init
    want = jax.eval_shape(lambda k: jinit(k, _jcfg(cfg)),
                          jax.random.PRNGKey(0))
    got = port_init(cfg, np.random.default_rng(0))

    def layout(tree):
        return jax.tree.map(lambda x: (tuple(x.shape), str(x.dtype).replace(
            "torch.", "")), tree)

    assert layout(got) == layout(want)
    assert not got["final_proj"]["w"].any()
    assert not got["final_ada"]["w"].any()


def test_diffusion_params_from_numpy_keeps_layout():
    cfg = smoke("flux-dev", torch.bfloat16)
    tree = numpy_weights(cfg)
    got = tdiff.diffusion_params_from_numpy(tree, torch.bfloat16,
                                            device="cpu")
    assert got["double"]["img_attn"]["wq"]["w"].shape == (
        cfg.n_double_blocks, cfg.d_model, cfg.d_model)
    assert all(x.dtype == torch.bfloat16 for x in jax.tree.leaves(got))
    np.testing.assert_array_equal(
        got["single"]["ada"]["w"].float().numpy(),
        np.asarray(jnp.asarray(tree["single"]["ada"]["w"], jnp.bfloat16),
                   np.float32))


@pytest.mark.parametrize("dim", [256, 7])
def test_timestep_embedding_matches_reference(dim):
    t = np.array([0.0, 1.0, 17.5, 500.0, 999.0], np.float32)
    want = _jit(lambda x: jdit.timestep_embedding(x, dim))(jnp.asarray(t))
    got = tdit.timestep_embedding(torch.as_tensor(t), dim)
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("g,dim", [(4, 64), (32, 3072), (3, 10)])
def test_sincos_2d_matches_reference(g, dim):
    want = _jit(lambda: jmmdit.sincos_2d(g, dim))()
    got = tmmdit.sincos_2d(g, dim)
    assert _rel_err(got, want) <= 1e-5


def test_ddim_timesteps_exact():
    """jnp.linspace(train_steps - 1, 0, n).astype(int32) (the float32
    values bit-equal too) at 1-40 steps and a few longer runs up to 352,
    where the port's formula stops being XLA's (diffusion.linspace_f32)."""
    for train_steps in (1000, 50):
        for n in list(range(1, 41)) + [50, 100, 250, 333, 352]:
            want = np.asarray(jnp.linspace(train_steps - 1, 0, n))
            got = tdiff.linspace_f32(train_steps - 1, 0, n).numpy()
            np.testing.assert_array_equal(got, want)
            assert tdiff.ddim_timesteps(n, train_steps) == list(
                want.astype(np.int32))


def test_ddpm_schedule_matches_reference():
    want = jdiff.ddpm_schedule(1000)
    got = tdiff.ddpm_schedule(1000)
    for k in ("betas", "alphas", "alpha_bars"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6, atol=0,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", list(DIT_GRIDS))
def test_dit_forward_matches_reference(dtype, grid):
    img_res, r = DIT_GRIDS[grid]
    cfg = smoke("dit-l2", getattr(torch, dtype), img_res=img_res)
    jp, tp = _pair(cfg)
    lat = _latents(cfg, r)
    t = np.array([3.0, 871.0], np.float32)
    y = np.array([1, cfg.n_classes], np.int32)        # a class, the null
    want = _jit(lambda p, x, t, y: jdit.dit_forward(p, _jcfg(cfg), x, t, y))(
        jp, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(y))
    with torch.no_grad():
        got = tdit.dit_forward(tp, cfg, torch.as_tensor(lat),
                               torch.as_tensor(t), torch.as_tensor(y))
    assert got.dtype == cfg.dtype
    assert _rel_err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_txt", [TXT, 1])
def test_mmdit_forward_matches_reference(dtype, n_txt):
    cfg = smoke("flux-dev", getattr(torch, dtype))
    jp, tp = _pair(cfg)
    lat = _latents(cfg, cfg.latent_res)
    t = np.array([0.0, 0.73], np.float32)
    txt = _txt(cfg, n=n_txt)
    want = _jit(lambda p, x, t, e: jmmdit.mmdit_forward(
        p, _jcfg(cfg), x, t, e))(jp, jnp.asarray(lat), jnp.asarray(t),
                                 jnp.asarray(txt))
    with torch.no_grad():
        got = tmmdit.mmdit_forward(tp, cfg, torch.as_tensor(lat),
                                   torch.as_tensor(t), torch.as_tensor(txt))
    assert got.dtype == cfg.dtype
    assert _rel_err(got, want) <= TOL[dtype]


# ---------------------------------------------------------------------------
# losses and samplers, from the same key
# ---------------------------------------------------------------------------

def test_train_loss_matches_reference(case):
    c = case
    cfg, seed = c["cfg"], 11
    r = cfg.latent_res or cfg.img_res // 8
    lat = _latents(cfg, r)
    if cfg.is_mmdit:
        txt = _txt(cfg)
        want = _jit(lambda p, x, e, k: jdiff.rf_train_loss(
            p, c["jcfg"], x, e, k))(c["jp"], jnp.asarray(lat),
                                    jnp.asarray(txt),
                                    jax.random.PRNGKey(seed))
        with torch.no_grad():
            got = tdiff.rf_train_loss(c["tp"], cfg, torch.as_tensor(lat),
                                      torch.as_tensor(txt),
                                      prng.PRNGKey(seed))
    else:
        y = np.array([2, 7], np.int32)
        want = _jit(lambda p, x, y, k: jdiff.dit_train_loss(
            p, c["jcfg"], x, y, k))(c["jp"], jnp.asarray(lat),
                                    jnp.asarray(y), jax.random.PRNGKey(seed))
        with torch.no_grad():
            got = tdiff.dit_train_loss(c["tp"], cfg, torch.as_tensor(lat),
                                       torch.as_tensor(y),
                                       prng.PRNGKey(seed))
    assert abs(float(got) - float(want)) <= (LOSS_REL[c["dtype"]]
                                             * abs(float(want)))


@pytest.mark.parametrize("n_steps", [2, 4])
def test_sampler_matches_reference(case, n_steps):
    """dit_sample (DDIM, y = 0) and rf_sample (Euler, the default zero
    text of TXT_TOKENS tokens) from the same key."""
    c = case
    cfg, key = c["cfg"], 5 + n_steps
    if cfg.is_mmdit:
        want = _jit(lambda p, k: jdiff.rf_sample(
            p, c["jcfg"], k, batch=B, n_steps=n_steps))(
            c["jp"], jax.random.PRNGKey(key))
        with torch.no_grad():
            got = tdiff.rf_sample(c["tp"], cfg, prng.PRNGKey(key), batch=B,
                                  n_steps=n_steps)
    else:
        want = _jit(lambda p, k: jdiff.dit_sample(
            p, c["jcfg"], k, batch=B, n_steps=n_steps))(
            c["jp"], jax.random.PRNGKey(key))
        with torch.no_grad():
            got = tdiff.dit_sample(c["tp"], cfg, prng.PRNGKey(key), batch=B,
                                   n_steps=n_steps)
    assert got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= TOL[c["dtype"]]
