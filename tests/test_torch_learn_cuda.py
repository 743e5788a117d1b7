"""The learning episode on the card against the same episode on the CPU
(`requires_cuda`: skipped without a card). Imports no JAX, so it runs
where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_learn_cuda.py

Tolerances: decisions (`explored`, `order`, `zooms`, `sent`, `chosen`)
and integer metrics exact; the per-step loss 1e-4 relative (float32
convolutions and sums in other orders on the two devices); the learned
heads: 98% of the elements within 1e-5 and every one within 3 lr per
update (an AdamW element whose gradient is at round-off level steps by
up to ~lr either way on either device). Full mode trains the whole
network, whose round-off-level elements (the attention key biases:
their gradient is zero but for round-off) then feed the loss: 1e-3
relative on the loss, 98% of the head elements within 1e-4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.fleet.api import FleetRunSpec, run_fleet  # noqa: E402
from repro_torch.learn.spec import DistillSpec  # noqa: E402
from repro_torch.train.optim import tree_leaves  # noqa: E402

N_STEPS = 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("head_only", [True, False])
def test_learning_episode_card_matches_cpu(cuda, head_only):
    spec = FleetRunSpec(provider="detector", n_cameras=2, n_steps=N_STEPS,
                        budget={"fps": 3.0}, seed=3, shortlist_k=9,
                        distill=DistillSpec(head_only=head_only),
                        metrics=True,
                        provider_kwargs={"scene_seeds": [3, 5]})
    on_card, on_cpu = run_fleet(spec), run_fleet(spec, device="cpu")
    for k in ("explored", "order", "zooms", "sent", "chosen"):
        np.testing.assert_array_equal(getattr(on_card.out, k).cpu().numpy(),
                                      getattr(on_cpu.out, k).numpy(),
                                      err_msg=k)
    np.testing.assert_allclose(on_card.distill_loss, on_cpu.distill_loss,
                               rtol=1e-4 if head_only else 1e-3)
    for k in ("chosen_rank", "frames_sent", "cells_visited"):
        np.testing.assert_array_equal(on_card.metrics[k].cpu().numpy(),
                                      on_cpu.metrics[k].numpy())
    errs = np.concatenate([
        np.abs(a.cpu().numpy() - b.numpy()).reshape(-1) for a, b in zip(
            tree_leaves(on_card.learned_params(None)["heads"]),
            tree_leaves(on_cpu.learned_params(None)["heads"]))])
    close = 1e-5 if head_only else 1e-4
    assert (errs <= close).mean() >= 0.98, np.sort(errs)[-20:]
    assert errs.max() <= 3 * DistillSpec().lr * N_STEPS
