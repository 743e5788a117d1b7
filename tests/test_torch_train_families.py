"""One train step of every family's SMOKE config, the port's
`train/trainer.make_train_step` against the JAX package's on the same
numpy-seeded weights and batch (tests/torch_train_inputs.py): the dense
LM (stablelm-3b), the MoE LM with MLA (deepseek-v3), ViT-B/16, Swin-B,
DiT-L/2, the Flux MMDiT and the MadEye detector, in float32 with 1 and 2
microbatches and in bf16 with 1; AdamW (the default) and, for the ViT,
Adafactor. Keys are `prng.PRNGKey(3)` on the port's side and
`jax.random.PRNGKey(3)` on the reference's (the same draws), so the
diffusion losses see the same timesteps and noise.

The reference runs jitted with XLA's `xla_allow_excess_precision` off,
as in tests/test_torch_lm.py. Tolerances are `check_step`'s
(torch_train_inputs.py): loss and grad_norm 1e-5 relative in float32 and
2e-3 in bf16; parameters 1e-6 but AdamW's round-off elements (3 lr) and
bf16's one-ulp roundings; moments float32 on both sides. Adafactor
(float32): see its test.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.scene import prng  # noqa: E402
from repro_torch.train import trainer as ttrainer  # noqa: E402
from repro_torch.train.optim import (  # noqa: E402
    AdafactorState,
    AdamState,
    tree_leaves,
)
from torch_train_inputs import (  # noqa: E402
    LR,
    ROUNDOFF,
    TRAIN_ARCHS,
    check_step,
    numpy_batch,
    smoke,
    torch_batch,
    train_params,
)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
CASES = ([(a, "float32", m) for a in TRAIN_ARCHS for m in (1, 2)]
         + [(a, "bfloat16", 1) for a in TRAIN_ARCHS
            if a != "madeye-approx"])


def to_jax(tree):
    """Port tensors -> JAX arrays of the same dtype (bf16 via float32)."""
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy(), dtype=jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def to_torch(tree):
    """JAX arrays -> CPU tensors of the same dtype (bf16 via float32)."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    if tree.dtype == jnp.bfloat16:
        return torch.as_tensor(np.array(tree.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.as_tensor(np.array(tree))


def _configs(arch, dtype):
    tc = smoke(arch, DTYPES[dtype][0])
    jc = j_smoke(arch)
    if hasattr(jc, "dtype"):
        jc = dataclasses.replace(jc, dtype=DTYPES[dtype][1])
    return tc, jc


def _run_both(arch, dtype, microbatches, **kw):
    """(port step outputs, reference step outputs as CPU tensors)."""
    tc, jc = _configs(arch, dtype)
    params = train_params(tc)
    batch = numpy_batch(tc, microbatches)
    ts = ttrainer.make_train_step(tc, microbatches=microbatches, **kw)
    got = ts.step(params, ts.init_opt(params), torch_batch(batch),
                  prng.PRNGKey(3))
    js = jtrainer.make_train_step(jc, microbatches=microbatches, **kw)
    jp = to_jax(params)
    step = jax.jit(js.step, compiler_options={
        "xla_allow_excess_precision": False})
    wp, wo, wm = step(jp, js.init_opt(jp),
                      {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(3))
    state = type(got[1])
    opt = state(torch.as_tensor(np.array(wo.step)),
                *[to_torch(x) for x in wo[1:]])
    return got, (to_torch(wp), opt, {k: float(v) for k, v in wm.items()})


@pytest.mark.parametrize("arch,dtype,microbatches", CASES,
                         ids=[f"{a}-{d}-mb{m}" for a, d, m in CASES])
def test_train_step_matches_jax(arch, dtype, microbatches):
    got, want = _run_both(arch, dtype, microbatches)
    assert isinstance(got[1], AdamState)
    assert int(got[1].step) == int(want[1].step) == 1
    assert got[1].step.dtype == torch.int32
    want_dtype = getattr(smoke(arch, DTYPES[dtype][0]), "dtype",
                         torch.float32)
    for p in tree_leaves(got[0]):
        assert p.dtype in (want_dtype, torch.float32)   # routers float32
    check_step(got, want, DTYPES[dtype][0], f"{arch} {dtype} "
               f"mb{microbatches}")


def test_adafactor_train_step_matches_jax():
    """Adafactor normalises each gradient by its own second moment, so a
    leaf whose gradient is round-off throughout (the attention key bias:
    softmax does not see it) takes a step of noise, as AdamW's round-off
    elements do, whose RMS the update's clip holds to lr on each side:
    such a leaf (largest second-moment factor below ROUNDOFF^2) is held
    to 2 lr in RMS. The update divides each gradient by its row and
    column's factors, so an element far below its row's scale carries
    its gradient's relative round-off: every other leaf is held to 1e-3
    lr in RMS and 0.05 lr at most (measured 1.2e-4 lr and 1.3e-2 lr),
    and the factors to 1e-5 of each leaf's largest."""
    got, want = _run_both("vit-b16", "float32", 2, optimizer="adafactor")
    assert isinstance(got[1], AdafactorState)
    assert int(got[1].step) == 1
    for k in ("loss", "grad_norm"):
        assert abs(float(got[2][k]) - want[2][k]) <= 1e-5 * abs(want[2][k])
    rough = []
    for vr, v in zip(tree_leaves(want[1].vr), tree_leaves(want[1].v)):
        rough.append(float(torch.maximum(vr.max(), v.max()))
                     < ROUNDOFF ** 2)
    assert 0 < sum(rough) < len(rough) // 10
    for g, w, r in zip(tree_leaves(got[0]), tree_leaves(want[0]), rough):
        assert g.dtype == w.dtype and g.shape == w.shape
        rms = float((g - w).square().mean().sqrt())
        if r:
            assert rms <= 2 * LR
        else:
            assert rms <= 1e-3 * LR
            assert float((g - w).abs().max()) <= 0.05 * LR
    for tree_g, tree_w in zip(got[1][1:], want[1][1:]):
        for g, w, r in zip(tree_leaves(tree_g), tree_leaves(tree_w), rough):
            assert g.dtype == w.dtype == torch.float32
            assert g.shape == w.shape
            if not r:
                top = max(float(w.abs().max()), 1e-30)
                assert float((g - w).abs().max()) <= 1e-5 * top


def test_batch_specs_match_jax():
    """Keys, shapes and dtypes of every family's batch at 1 and 4
    microbatches, including the diffusion latent-resolution rule."""
    from repro.configs import get_config as j_config
    from repro.configs.base import ShapeSpec as JShape
    from repro_torch.configs import get_config as t_config
    from repro_torch.configs.base import ShapeSpec as TShape

    pairs = [(smoke(a), j_smoke(a)) for a in TRAIN_ARCHS] + [
        (t_config(a), j_config(a)) for a in ("flux-dev", "dit-l2")]
    for tc, jc in pairs:
        for img in (256, 512):
            kw = dict(seq_len=32, global_batch=8, img_res=img)
            for mb in (1, 4):
                t = ttrainer.batch_specs(tc, TShape("s", "train", **kw),
                                         microbatches=mb)
                j = jtrainer.batch_specs(jc, JShape("s", "train", **kw),
                                         microbatches=mb)
                assert list(t) == list(j)
                for k in t:
                    assert t[k].shape == j[k].shape, (tc.name, k)
                    assert str(t[k].dtype).removeprefix("torch.") == \
                        str(j[k].dtype)
