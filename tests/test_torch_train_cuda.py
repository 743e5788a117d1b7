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

At full width (weights from seeded CUDA generators; no step launches a
kernel, the losses run the plain attention):

- stablelm-3b at full depth in bf16 with remat, AdamW with donated
  state, 3 steps at global batch 8 x 2048 tokens in 4 microbatches
  (train_4k's 256 x 4096 cut to fit one card): loss and grad_norm
  finite, the moments float32 after every step, every leaf moved but
  the norm scales (a bf16 value of magnitude >= 0.5 rounds an lr-sized
  update away), the embedding sampled at the rows of the batch's
  tokens;
- stablelm-3b at depth 2 in float32, batch 4 x 2048: the gradients with
  remat on and off within 1e-6 of each leaf's largest (the same kernels
  on the same inputs), one AdamW step in 4 microbatches against 1 within
  `check_step`'s float32 tolerances;
- ViT-B/16 in bf16 with Adafactor, 3 steps at batch 128: finite losses,
  every leaf moved but the norm scales;
- `python -m repro_torch.launch.train --arch vit-b16 --steps 6 --batch
  8` as a subprocess, its checkpoint restored (paths and dtypes as
  pinned) and saved again byte-equal, then `--steps 10` resuming from
  it.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
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


def _sample(params, rows=None) -> list:
    """A clone of each leaf's first 4096 elements; of the embedding table
    (with `rows`), its rows of those tokens."""
    table = params.get("embed", {}).get("table") if rows is not None \
        else None
    return [(x[rows] if x is table else x.reshape(-1)[:4096]).clone()
            for x in tree_leaves(params)]


def _assert_moved(before: list, after: list) -> None:
    """Every sampled leaf moved somewhere, but those whose sampled values
    are all of magnitude >= 0.5 (norm scales at 1.0: in bf16 their
    spacing 2^-7 is 78 lr, so an lr-sized update rounds away)."""
    for b, a in zip(before, after):
        assert bool((b.float().abs() >= 0.5).all()) or bool((a != b).any()), \
            f"a {tuple(b.shape)} sample did not move"


def _train(ts, params, opt, batches, key):
    """ts.step over `batches` (step i's key fold_in(key, 10**6 + i), as
    the launcher's): no kernel launches, loss and grad_norm finite, an
    AdamW state's moments float32 after every step."""
    for i, batch in enumerate(batches):
        (params, opt, m), c = _counted(lambda: ts.step(
            params, opt, batch, prng.fold_in(key, 10 ** 6 + i)))
        assert c == {}
        assert math.isfinite(float(m["loss"]))
        assert math.isfinite(float(m["grad_norm"]))
        if hasattr(opt, "mu"):
            assert {t.dtype for t in tree_leaves(opt.mu)
                    + tree_leaves(opt.nu)} == {torch.float32}
    return params


@pytest.mark.requires_cuda
def test_full_width_stablelm_train_steps(cuda):
    cfg = get_config("stablelm-3b")
    assert cfg.remat and cfg.dtype == torch.bfloat16
    # donated, as the launcher's loop does: a functional update holds
    # the old and the new state together, past the card's memory
    ts = trainer.make_train_step(cfg, optimizer="adamw", microbatches=4,
                                 donate=True)
    params = ts.init_params(torch.Generator(device=cuda).manual_seed(0),
                            cuda)
    opt = ts.init_opt(params)
    key = prng.PRNGKey(0, device=cuda)
    shape = ShapeSpec("train_4k, cut", "train", seq_len=2048,
                      global_batch=8)
    batches = [{k: v.reshape((4, -1) + v.shape[1:]) for k, v in
                tlaunch.synthetic_batch(cfg, shape, prng.fold_in(
                    key, i)).items()} for i in range(3)]
    rows = batches[0]["tokens"].reshape(-1)[:2].long()
    before = _sample(params, rows)
    params = _train(ts, params, opt, batches, key)
    _assert_moved(before, _sample(params, rows))


@pytest.mark.requires_cuda
def test_full_width_stablelm_remat_and_microbatches(cuda):
    cfg = dataclasses.replace(get_config("stablelm-3b"), n_layers=2,
                              dtype=torch.float32)
    params = trainer.make_train_step(cfg).init_params(
        torch.Generator(device=cuda).manual_seed(1), cuda)
    key = prng.PRNGKey(1, device=cuda)
    batch = tlaunch.synthetic_batch(cfg, ShapeSpec(
        "check", "train", seq_len=2048, global_batch=4), key)
    out = []
    for flag in (True, False):
        got, c = _counted(lambda: trainer.value_and_grad(
            trainer._loss_for(dataclasses.replace(cfg, remat=flag)),
            params, batch, key))
        assert c == {}
        out.append(got)
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert float((a - b).abs().max()) <= 1e-6 * max(
            float(b.abs().max()), 1e-30)
    del out
    steps = []
    for m in (1, 4):
        ts = trainer.make_train_step(cfg, microbatches=m)
        b = batch if m == 1 else {k: v.reshape((m, -1) + v.shape[1:])
                                  for k, v in batch.items()}
        got, c = _counted(lambda: ts.step(params, ts.init_opt(params), b,
                                          key))
        assert c == {}
        steps.append(got)
    check_step(steps[1], steps[0], torch.float32, "4 microbatches vs 1")


@pytest.mark.requires_cuda
def test_full_width_vit_b16_adafactor_steps(cuda):
    cfg = get_config("vit-b16")
    ts = trainer.make_train_step(cfg, optimizer="adafactor")
    params = ts.init_params(torch.Generator(device=cuda).manual_seed(2),
                            cuda)
    key = prng.PRNGKey(2, device=cuda)
    shape = ShapeSpec("cls_224", "train", img_res=cfg.img_res,
                      global_batch=128)
    batches = [tlaunch.synthetic_batch(cfg, shape, prng.fold_in(key, i))
               for i in range(3)]
    before = _sample(params)
    params = _train(ts, params, ts.init_opt(params), batches, key)
    _assert_moved(before, _sample(params))


@pytest.mark.requires_cuda
def test_train_launcher_subprocess_resumes(cuda, tmp_path):
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, (str(root / "src"), env.get("PYTHONPATH"))))
    ckpt_dir = str(tmp_path / "ckpt")
    for steps in (6, 10):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "vit-b16", "--steps", str(steps), "--batch", "8",
             "--ckpt-dir", ckpt_dir], env=env, cwd=root,
            capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
        if steps == 10:
            assert "restored checkpoint step 6" in proc.stdout
            continue
        ts = trainer.make_train_step(get_config("vit-b16"))
        like = ts.init_params(torch.Generator(device=cuda), cuda)
        like = (like, ts.init_opt(like))
        tree, manifest = ckpt.restore(ckpt_dir, 6, like)
        paths = ckpt.tree_paths(like)
        assert manifest["paths"] == paths
        assert {p: m["dtype"] for p, m in manifest["meta"].items()} == {
            p: ("int32" if p == "[1].step" else "bfloat16"
                if p.startswith("[0]") else "float32") for p in paths}
        assert int(tree[1].step) == 6 and manifest["step"] == 6
        again = ckpt.save(str(tmp_path / "again"), 6, tree)
        for name in ("manifest.json", "shard_00000.msgpack"):
            assert (Path(again) / name).read_bytes() == (
                Path(ckpt_dir) / "step_00000006" / name).read_bytes()
    assert ckpt.latest_step(ckpt_dir) == 10
