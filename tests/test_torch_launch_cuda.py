"""The launchers on the card (`requires_cuda`: skipped without one).
Imports no JAX, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_launch_cuda.py

chip_smoke.py phase 8h's check on one small cell: the dry run of
vit-b16's SMOKE config at serve_b128 on a 1 x 1 mesh of a one-rank
"fake" world, fake tensors on the card, counts the FLOPs that
FlopCounterMode counts when build_cell's fn runs for real on a one-rank
NCCL mesh (numpy weights, laid out by the cell's in_shardings). Every
process group made here is torn down after the test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor.experimental import (  # noqa: E402
    implicit_replication,
)
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.train.elastic import reshard  # noqa: E402
from torch_dist import smoke_variant  # noqa: E402


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
