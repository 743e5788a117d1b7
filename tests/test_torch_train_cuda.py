"""The training substrate on the card (`requires_cuda`: skipped without
one). Imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_cuda.py

One AdamW train step of every family's SMOKE config on the card against
the CPU on numpy-drawn weights and batches, with the CPU tests'
tolerances (tests/torch_train_inputs.py `check_step`), launching no
kernel; remat on and off on the card; a checkpoint written from card
tensors restored onto the card bit for bit (tensor and TensorSpec
leaves); the launcher's train loop resumed from its checkpoint on the
card.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.scene import prng  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from repro_torch.train.optim import tree_leaves, tree_map  # noqa: E402
from torch_train_inputs import (  # noqa: E402
    TRAIN_ARCHS,
    check_step,
    numpy_batch,
    smoke,
    torch_batch,
    train_params,
)

CASES = [(a, d) for a in TRAIN_ARCHS for d in ("float32", "bfloat16")
         if not (a == "madeye-approx" and d == "bfloat16")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch,dtype", CASES,
                         ids=[f"{a}-{d}" for a, d in CASES])
def test_smoke_train_step_card_matches_cpu(cuda, arch, dtype):
    cfg = smoke(arch, getattr(torch, dtype))
    ts = trainer.make_train_step(cfg)
    params = train_params(cfg)
    batch = numpy_batch(cfg)
    want = ts.step(params, ts.init_opt(params), torch_batch(batch),
                   prng.PRNGKey(3))
    pd = tree_map(lambda t: t.to(cuda), params)
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        got, c = _counted(lambda: ts.step(pd, ts.init_opt(pd),
                                          torch_batch(batch, cuda),
                                          prng.PRNGKey(3, device=cuda)))
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            saved
    assert c == {}
    check_step(got, want, getattr(torch, dtype), f"{arch} {dtype}")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", ["stablelm-3b", "vit-b16", "flux-dev"])
def test_remat_gradients_equal_on_card(cuda, arch):
    cfg = smoke(arch, torch.float32)
    params = train_params(cfg, device=cuda)
    batch = torch_batch(numpy_batch(cfg), cuda)
    out = [trainer.value_and_grad(trainer._loss_for(
        dataclasses.replace(cfg, remat=flag)), params, batch,
        prng.PRNGKey(3, device=cuda)) for flag in (True, False)]
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1e-30)


@pytest.mark.requires_cuda
def test_checkpoint_roundtrip_on_card(cuda, tmp_path):
    rng = np.random.default_rng(0)
    tree = ({"w": torch.as_tensor(rng.normal(size=(33, 7)),
                                  dtype=torch.bfloat16, device=cuda)},
            {"step": torch.tensor(3, dtype=torch.int32, device=cuda),
             "ok": torch.ones(4, dtype=torch.bool, device=cuda)})
    ckpt.save(str(tmp_path), 3, tree)
    like = ({"w": trainer.TensorSpec((33, 7), torch.bfloat16)},
            {"step": torch.zeros((), dtype=torch.int32, device=cuda),
             "ok": torch.zeros(4, dtype=torch.bool)})
    out, _ = ckpt.restore(str(tmp_path), 3, like)
    assert out[0]["w"].device.type == "cuda"       # a spec: the card
    assert out[1]["ok"].device.type == "cpu"       # like's own device
    assert torch.equal(out[0]["w"], tree[0]["w"])
    assert torch.equal(out[1]["step"], tree[1]["step"])
    assert torch.equal(out[1]["ok"].to(cuda), tree[1]["ok"])


@pytest.mark.requires_cuda
def test_train_loop_resumes_on_card(cuda, tmp_path, capsys):
    cfg = smoke("vit-b16")
    shape = ShapeSpec("t", "train", img_res=cfg.img_res, global_batch=4)
    d = str(tmp_path)
    tlaunch.train_loop(cfg, shape, steps=2, lr=1e-3, ckpt_dir=d,
                       device=cuda)
    params, opt = tlaunch.train_loop(cfg, shape, steps=4, lr=1e-3,
                                     ckpt_dir=d, device=cuda)
    assert "restored checkpoint step 2" in capsys.readouterr().out
    assert int(opt.step) == 4 and ckpt.latest_step(d) == 4
    assert all(p.device.type == "cuda" for p in tree_leaves(params))
