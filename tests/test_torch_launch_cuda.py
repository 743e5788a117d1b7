"""The launchers on the card (`requires_cuda`: skipped without one).
Imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_launch_cuda.py

The dry run of a cell on a 1 x 1 mesh of a one-rank "fake" world, fake
tensors on the card, counts the FLOPs that FlopCounterMode counts when
build_cell's fn runs for real on a one-rank NCCL mesh (numpy weights,
laid out by the cell's in_shardings): vit-b16's SMOKE config at
serve_b128, and at full size vit-b16 serve_b128 and cls_384 and dit-l2
gen_fast, whose real runs launch no kernel (the cells run impl="xla"),
give finite outputs and agree with the same fn on plain tensors (bf16
outputs within 4 bf16 ulps of their largest magnitude: the products see
other shapes, rows flattened and attention per shard, so cuBLAS may sum
in another order; a train step within `check_step`'s bf16 tolerances).
The full configs' dry runs on the fake (16, 16) mesh: stablelm-3b
decode_32k and vit-b16 serve_b128. Every process group made here is
torn down after the test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor.experimental import (  # noqa: E402
    implicit_replication,
)
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.configs import get_config, get_shape  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    tree_leaves,
    tree_map_with_path,
)
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.train.elastic import reshard  # noqa: E402
from torch_dist import smoke_variant  # noqa: E402
from torch_train_inputs import check_step  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert not dist.is_initialized()
    yield torch.device("cuda")
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", [("vit-b16", "serve_b128")])
def test_real_run_flops_equal_dry_run_on_card(cuda, cell):
    arch, shape = cell
    name = smoke_variant(arch)
    dry = dryrun.run_cell(name, shape, mesh=dryrun.one_rank_mesh(cuda),
                          device=cuda, verbose=False)
    dist.destroy_process_group()

    c = build_cell(name, shape, make_debug_mesh())
    args = reshard(c.make_args(np.random.default_rng(0), cuda),
                   c.in_shardings)
    with implicit_replication(), FlopCounterMode(display=False) as fc:
        out = c.fn(*args)
    assert torch.isfinite(out.full_tensor()).all()
    assert fc.get_total_flops() == dry["flops"] > 0


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", [("stablelm-3b", "decode_32k"),
                                  ("vit-b16", "serve_b128")],
                         ids=["stablelm-3b-decode_32k",
                              "vit-b16-serve_b128"])
def test_full_config_dry_run_on_fake_mesh(cuda, cell):
    dryrun.fake_world()
    r = dryrun.run_cell(*cell, device=cuda, verbose=False)
    assert r["flops"] > 0 and r["bytes_per_device"] > 0


def _whole(tree):
    """Every DTensor leaf of `tree` as the full tensor."""
    return tree_map_with_path(lambda _, t: t.full_tensor() if hasattr(
        t, "full_tensor") else t, tree)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cell", [("vit-b16", "serve_b128"),
                                  ("dit-l2", "gen_fast"),
                                  ("vit-b16", "cls_384")],
                         ids=["vit-b16-serve_b128", "dit-l2-gen_fast",
                              "vit-b16-cls_384"])
def test_full_cell_real_run_on_card(cuda, cell):
    arch, shape = cell
    dry = dryrun.run_cell(arch, shape, mesh=dryrun.one_rank_mesh(cuda),
                          device=cuda, verbose=False)
    dist.destroy_process_group()
    c = build_cell(arch, shape, make_debug_mesh())
    plain = c.make_args(np.random.default_rng(24), cuda)
    args = reshard(plain, c.in_shardings)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    with implicit_replication(), FlopCounterMode(display=False) as fc:
        out = c.fn(*args)
    torch.cuda.synchronize()
    assert {k: v for k, v in _lib.launch_counts().items()
            if v and k != "threefry"} == {}
    assert fc.get_total_flops() == dry["flops"]
    got, want = _whole(out), c.fn(*plain)
    cfg = get_config(arch)
    if get_shape(cfg, shape).kind == "train":
        check_step(got, want, cfg.dtype, f"{arch} x {shape}")
        return
    pairs = [(g, w) for g, w in zip(tree_leaves(got), tree_leaves(want))
             if isinstance(w, torch.Tensor) and w.is_floating_point()]
    assert pairs
    for g, w in pairs:
        assert bool(torch.isfinite(g).all())
        top = float(w.float().abs().max())
        assert float((g.float() - w.float()).abs().max()) <= \
            2.0 ** -6 * max(top, 1e-30)
