"""Sharding on the card (`requires_cuda`: skipped without one). Imports
no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_shard_cuda.py

A one-rank NCCL mesh (`make_debug_mesh()` makes the group itself) and
its collectives; the sharded smoke fleet on the card (ShardSpec("debug"),
frozen and distilling) against the same spec unsharded on the card and
on the CPU (weights drawn by numpy, the same under any PyTorch);
DTensor checkpoints from the card restored bit for bit. Every process
group made here is torn down after its test.

At full width (weights from seeded CUDA generators):

- the main path's cell (madeye-approx, 64 cameras, 8 steps,
  shortlist_k=18) with ShardSpec("debug") on a one-rank NCCL mesh
  launches the four main-path kernels once a step, flash_attention once
  a ViT layer, and nothing else (threefry and dense aside) and is
  bit-equal to the unsharded run; split over two spawned processes
  sharing the card in a gloo group (32 cameras each), each rank
  launches them as often, the gathered
  decisions equal the unsharded run's, pred_acc and accuracy within
  1e-5 (each rank's detector forward runs over half the crops, where
  cuBLAS may sum in another order);
- stablelm-3b's 32 layers in bf16 through make_pipelined_forward (one
  stage, 4 microbatches of [1, 2048], flash attention: one launch a
  layer and microbatch), each output bit-equal to the layers run in
  sequence;
- ring_reduce_attend at stablelm-3b's decode shape against the plain
  full attention (float32 within 1e-5; bf16 within one bf16 ulp of the
  outputs' largest magnitude), psum_scatter_grads and ring_allgather
  identities at one rank, no kernel launched;
- stablelm-3b's bf16 parameters laid out by param_shardings, saved,
  restored and laid out again: bit-equal;
- crosspod_allreduce_compressed over ViT-B/16's float32 gradients at one
  rank: the mean is the dequantized gradient, within half a
  quantization step of the exact one.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import torch_dist  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    gather_fleet,
    psum_scatter_grads,
    ring_allgather,
    ring_reduce_attend,
)
from repro_torch.distributed.pipeline import (  # noqa: E402
    make_pipelined_forward,
    split_stages,
)
from repro_torch.distributed.sharding import param_shardings  # noqa: E402
from repro_torch.fleet.api import FleetRunSpec, run_fleet  # noqa: E402
from repro_torch.fleet.runner import save_detector_params  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import attention, layers, vit  # noqa: E402
from repro_torch.models import detector as tdet  # noqa: E402
from repro_torch.models.transformer import dense_block, lm_init  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import compression, trainer  # noqa: E402
from repro_torch.train.elastic import reshard  # noqa: E402
from repro_torch.train.optim import tree_leaves  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not dist.is_initialized()
    yield torch.device("cuda")
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.requires_cuda
def test_one_rank_nccl_mesh_and_collectives(cuda):
    mesh = make_debug_mesh()
    assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 1, 4, 32), generator=gen, device=cuda)
    k = torch.randn((2, 64, 4, 32), generator=gen, device=cuda)
    v = torch.randn((2, 64, 4, 32), generator=gen, device=cuda)
    got = ring_reduce_attend(q, k, v, (mesh, "model"), scale=0.2)
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.2, -1)
    torch.testing.assert_close(got, torch.einsum("bhqk,bkhd->bqhd", w, v),
                               atol=1e-5, rtol=0)
    g = {"w": torch.randn((8, 3), generator=gen, device=cuda)}
    assert torch.equal(psum_scatter_grads(g, (mesh, "data"))["w"], g["w"])
    assert torch.equal(ring_allgather(g["w"], (mesh, "model")), g["w"][None])
    t = {"a": torch.arange(6, device=cuda).reshape(3, 2) > 2}
    assert torch.equal(gather_fleet(t, (mesh, "data"))["a"], t["a"])


def _summary(res):
    return (res.chosen, res.frames_sent, res.out.pred_acc.cpu().numpy(),
            None if res.learned is None else
            res.learned_params(None)["heads"]["cls"]["w"].cpu().numpy())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("distill", [None, True], ids=["frozen",
                                                         "distill"])
def test_sharded_smoke_fleet_on_the_card(cuda, distill, tmp_path):
    """ShardSpec("debug") on the card decides as the unsharded run on the
    card (bit-equal: one rank) and as the CPU (within the card-vs-CPU
    tolerances of tests/test_torch_learn_cuda.py)."""
    npz = save_detector_params(str(tmp_path / "det.npz"), tdet.detector_init(
        np.random.default_rng(4), get_smoke_config("madeye-approx"), "cpu"))
    kw = dict(provider="detector", n_cameras=4, n_steps=4, seed=3,
              budget={"fps": 3.0}, shortlist_k=9, distill=distill,
              provider_kwargs={"det_params": npz, "thresh": 0.3})
    sharded = _summary(run_fleet(FleetRunSpec(shard={"kind": "debug"},
                                              **kw)))
    card = _summary(run_fleet(FleetRunSpec(**kw)))
    cpu = _summary(run_fleet(FleetRunSpec(**kw), device="cpu"))
    assert sharded[:2] == card[:2] == cpu[:2]
    np.testing.assert_array_equal(sharded[2], card[2])
    np.testing.assert_allclose(sharded[2], cpu[2], atol=1e-5)
    if distill:
        np.testing.assert_array_equal(sharded[3], card[3])
        np.testing.assert_allclose(sharded[3], cpu[3], atol=1e-5)


@pytest.mark.requires_cuda
def test_dtensor_checkpoint_from_the_card(cuda, tmp_path):
    mesh = make_debug_mesh()
    tree = {"layers": {"wq": {"w": torch.randn((2, 64, 64), device=cuda)
                              .to(torch.bfloat16)}},
            "norm": torch.ones(64, device=cuda)}
    laid = reshard(tree, param_shardings(tree, mesh))
    ckpt.save(str(tmp_path), 3, laid)
    back, manifest = ckpt.restore(str(tmp_path), 3, tree)
    assert manifest["n_processes"] == 1
    again = reshard(back, param_shardings(back, mesh))
    assert torch.equal(again["layers"]["wq"]["w"].full_tensor(),
                       tree["layers"]["wq"]["w"])
    assert torch.equal(again["norm"].full_tensor(), tree["norm"])


MAIN_PATH_KERNELS = ("shape_search", "budget_walk", "oracle_pass",
                     "crop_patchify")
FULL = FleetRunSpec(provider="detector", n_cameras=64, n_steps=8,
                    shortlist_k=18,
                    provider_kwargs={"det_cfg": get_config("madeye-approx")})
# each step's (and the warm-up's) launches: the main path's kernels, and
# flash_attention once for each of the ViT's layers
FULL_LAUNCHES = {k: FULL.n_steps + 1 for k in MAIN_PATH_KERNELS} | {
    "flash_attention": (FULL.n_steps + 1)
    * get_config("madeye-approx").n_layers}


def _counted(fn):
    """(fn(), the kernels it launched {name: n}) but threefry and dense
    (tests/test_torch_prng_cuda.py and tests/test_torch_dense_cuda.py
    hold them)."""
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _lib.launch_counts().items()
                 if v and k not in ("threefry", "dense")}


@pytest.mark.requires_cuda
def test_full_width_fleet_one_rank_matches_unsharded(cuda):
    whole = run_fleet(FULL)
    res, counts = _counted(lambda: run_fleet(dataclasses.replace(
        FULL, shard={"kind": "debug"})))
    assert counts == FULL_LAUNCHES
    for k in ("chosen", "frames_sent", "accuracy", "acc_per_step"):
        assert getattr(res, k) == getattr(whole, k), k
    assert torch.equal(res.out.pred_acc, whole.out.pred_acc)


@pytest.mark.requires_cuda
def test_full_width_fleet_two_processes_share_the_card(cuda, tmp_path):
    whole = run_fleet(FULL)
    pred = whole.out.pred_acc.cpu().numpy()
    for r in torch_dist.spawn(torch_dist.card_fleet_rank, 2, tmp_path,
                              FULL, 2).join():
        assert r["launches"] == FULL_LAUNCHES
        assert r["chosen"] == whole.chosen
        assert r["frames_sent"] == whole.frames_sent
        assert float(np.abs(r["pred_acc"] - pred).max()) <= 1e-5
        assert abs(r["accuracy"] - whole.accuracy) <= 1e-5


def _stablelm_bf16(cuda):
    cfg = get_config("stablelm-3b")
    return cfg, lm_init(torch.Generator(device=cuda).manual_seed(22), cfg,
                        cuda)


@pytest.mark.requires_cuda
def test_full_width_pipeline_bit_equal_to_sequence(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    cfg, params = _stablelm_bf16(cuda)
    mesh = make_debug_mesh()
    micro, seq = 4, 2048
    toks = torch.randint(0, cfg.vocab, (micro, 1, seq), device=cuda,
                         generator=torch.Generator(device=cuda)
                         .manual_seed(23))
    angles = attention.rope_frequencies(cfg.resolved_head_dim, seq,
                                        cfg.rope_theta, device=cuda)

    def body(lp, x, extra):
        return dense_block(lp, x, cfg, extra, "flash")

    fn = make_pipelined_forward(body, mesh, 1)
    with torch.no_grad():
        x = layers.embedding(params["embed"], toks)     # [M, 1, S, D]
        piped, counts = _counted(lambda: fn(split_stages(params["layers"],
                                                         1), x, angles))
        outs = []
        for h in x:
            for i in range(cfg.n_layers):
                h = body(layers.layer_params(params["layers"], i), h,
                         angles)
            outs.append(h)
    assert counts == {"flash_attention": micro * cfg.n_layers}
    assert bool(torch.isfinite(piped).all())
    assert torch.equal(piped, torch.stack(outs))


@pytest.mark.requires_cuda
def test_full_width_collectives_at_one_rank(cuda):
    """ring_reduce_attend at stablelm-3b's decode shape: 4 requests, a
    cache of 2048 prompt + 16 decoded positions, 32 heads of 80."""
    mesh = make_debug_mesh()
    b, s, h, d = 4, 2064, 32, 80
    gen = torch.Generator(device=cuda).manual_seed(24)
    q = torch.randn((b, 1, h, d), generator=gen, device=cuda)
    k = torch.randn((b, s, h, d), generator=gen, device=cuda)
    v = torch.randn((b, s, h, d), generator=gen, device=cuda)
    grads = {"w": torch.randn((4096, 2560), generator=gen, device=cuda),
             "b": torch.randn((2560,), generator=gen, device=cuda)}
    x = torch.randn((8, 80), generator=gen, device=cuda)
    scale = 1.0 / math.sqrt(d)
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd = (t.to(dt) for t in (q, k, v))
        got, counts = _counted(lambda: ring_reduce_attend(
            qd, kd, vd, (mesh, "model"), scale=scale))
        assert counts == {} and got.dtype == dt
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qd.float(),
                                       kd.float()) * scale, -1)
        want = torch.einsum("bhqk,bkhd->bqhd", w, vd.float())
        tol = 1e-5 if dt == torch.float32 else 2.0 ** (
            math.floor(math.log2(float(want.abs().max()))) - 7)
        assert float((got.float() - want).abs().max()) <= tol
    (scattered, gathered), counts = _counted(lambda: (
        psum_scatter_grads(grads, (mesh, "data")),
        ring_allgather(x, (mesh, "model"))))
    assert counts == {}
    assert all(torch.equal(scattered[n], grads[n]) for n in grads)
    assert torch.equal(gathered, x[None])


@pytest.mark.requires_cuda
def test_full_width_elastic_round_trip(cuda, tmp_path):
    _, params = _stablelm_bf16(cuda)
    shardings = param_shardings(params, make_debug_mesh())

    def run():
        ckpt.save(str(tmp_path), 1, reshard(params, shardings))
        return reshard(ckpt.restore(str(tmp_path), 1, params)[0], shardings)

    back, counts = _counted(run)
    assert counts == {}
    flat_p, flat_b = tree_leaves(params), tree_leaves(back)
    assert len(flat_p) == len(flat_b)
    assert all(torch.equal(b.full_tensor(), p)
               for p, b in zip(flat_p, flat_b))


@pytest.mark.requires_cuda
def test_full_width_compression_at_one_rank(cuda):
    """ViT-B/16's float32 gradients at batch 8: round to nearest is half
    a step, plus the float32 rounding of the scaled value and of the
    product back."""
    cfg = dataclasses.replace(get_config("vit-b16"), dtype=torch.float32)
    gen = torch.Generator(device=cuda).manual_seed(25)
    params = vit.vit_init(gen, cfg, device=cuda)
    images = torch.rand((8, cfg.img_res, cfg.img_res, 3), generator=gen,
                        device=cuda)
    labels = torch.randint(0, cfg.n_classes, (8,), generator=gen,
                           device=cuda)
    _, grads = trainer.value_and_grad(
        lambda p: vit.vit_loss(p, cfg, images, labels), params)
    mesh = make_debug_mesh()
    (mean, _), counts = _counted(
        lambda: compression.crosspod_allreduce_compressed(
            grads, compression.init_ef(grads), group=(mesh, "data")))
    assert counts == {}
    for g, m in zip(tree_leaves(grads), tree_leaves(mean)):
        assert torch.equal(m, compression.dequantize_int8(
            *compression.quantize_int8(g)))
        step = max(float(g.abs().max()), 1e-12) / 127.0
        assert float((m - g).abs().max()) / step <= 0.5 + 1e-3
