"""In-episode continual distillation (paper §3.4): the episode carry
learns.

  spec.py   DistillSpec — the JSON-round-trippable config hung off
            FleetRunSpec.distill; None runs the exact frozen episode
  pairs.py  training pairs from the crops the budget actually SENT:
            teacher grades of the chosen/sent windows, student payload
            reused from the step's [F, K] forward
  loss.py   the distillation objective, reduced to models/detector
            .detector_loss_from_outputs
  loop.py   LearnState riding the carry; the cadence-gated per-camera
            optimizer step (train/optim) with per-camera clipping and
            idle-camera no-ops

Entry point: `FleetRunSpec(provider="detector", distill=True)` — see
fleet/api.py. The learning curve is read off the `chosen_rank` metric
(obs/metrics.py).
"""
from repro_torch.learn.loop import (
    LearnState,
    distill_step,
    distill_update,
    init_learn,
    lr_at,
    merged_params,
    optimizer_apply,
    trainable_mask,
)
from repro_torch.learn.loss import distill_full_loss, distill_head_loss
from repro_torch.learn.pairs import (
    PairBuffer,
    harvest_into_buffer,
    init_pair_buffer,
    select_sent_windows,
    teacher_window_targets,
)
from repro_torch.learn.spec import DistillSpec, normalize_distill
