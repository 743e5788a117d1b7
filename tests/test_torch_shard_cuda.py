"""Sharding on the card (`requires_cuda`: skipped without one). Imports
no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_shard_cuda.py

A one-rank NCCL mesh (`make_debug_mesh()` makes the group itself) and
its collectives; the sharded smoke fleet on the card (ShardSpec("debug"),
frozen and distilling) against the same spec unsharded on the card and
on the CPU (weights drawn by numpy, the same under any PyTorch);
DTensor checkpoints from the card restored bit for bit. Every process
group made here is torn down after its test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    gather_fleet,
    psum_scatter_grads,
    ring_allgather,
    ring_reduce_attend,
)
from repro_torch.distributed.sharding import param_shardings  # noqa: E402
from repro_torch.fleet.api import FleetRunSpec, run_fleet  # noqa: E402
from repro_torch.fleet.runner import save_detector_params  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.models import detector as tdet  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.elastic import reshard  # noqa: E402


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
