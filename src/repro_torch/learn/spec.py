"""DistillSpec — the declarative, JSON-round-trippable description of
one in-episode continual-distillation configuration.

Hung off `FleetRunSpec.distill` exactly like `MetricsSpec` hangs off
`.metrics`: frozen and hashable, field for field the reference
package's, so one spec JSON names the same run in both packages.
`distill=None` runs the exact frozen-params episode (decisions
bit-identical to a run without the field), any enabled spec the
learning variant.

The fields mirror the paper's knobs (§3.4: head-only fine-tuning with
only camera resources) plus the machinery that makes the update ride
the episode: how many sent crops to harvest per step, the per-camera
ring-buffer depth, and the update cadence.
"""
from __future__ import annotations

from dataclasses import dataclass

OPTIMIZERS = ("adamw", "sgd")
SCHEDULES = ("constant", "cosine")


@dataclass(frozen=True)
class DistillSpec:
    """Static (hashable) in-episode distillation config.

    enabled=False is equivalent to passing no spec at all (FleetRunSpec
    normalizes it to None). `head_only=True` is the paper's mode — only
    the final prediction heads train, per camera, on features staged
    from the inference forward (zero extra backbone compute);
    `head_only=False` trains the full network per camera from the staged
    patch tokens (the shared patch embedding stays frozen — it produced
    the tokens).

    harvest: sent crops captured per camera per step (chosen orientation
    first, then best predicted accuracy). buffer: per-camera pair ring
    depth the update trains over. every: optimizer-step cadence in
    controller steps. horizon/warmup parameterize the cosine schedule
    (in optimizer steps); constant ignores them.
    """
    enabled: bool = True
    optimizer: str = "adamw"        # adamw | sgd
    lr: float = 3e-3
    schedule: str = "constant"      # constant | cosine
    warmup: int = 0
    horizon: int = 256
    head_only: bool = True
    every: int = 1
    buffer: int = 8
    harvest: int = 2
    weight_decay: float = 0.0
    grad_clip: float | None = 1.0   # per-camera global-norm clip

    def __post_init__(self):
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"DistillSpec.optimizer must be one of "
                             f"{OPTIMIZERS}, got {self.optimizer!r}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"DistillSpec.schedule must be one of "
                             f"{SCHEDULES}, got {self.schedule!r}")
        for name in ("every", "buffer", "harvest"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"DistillSpec.{name} must be >= 1, got "
                    f"{getattr(self, name)}")
        if self.harvest > self.buffer:
            raise ValueError(
                f"DistillSpec.harvest={self.harvest} exceeds the "
                f"buffer={self.buffer} ring — later harvests of one step "
                f"would overwrite earlier ones before any update sees "
                f"them")
        if self.lr <= 0:
            raise ValueError(f"DistillSpec.lr must be > 0, got {self.lr}")


def normalize_distill(d) -> DistillSpec | None:
    """The FleetRunSpec normalization rule (mirrors `metrics`):
    True -> default spec, False/None -> None, dict -> DistillSpec(**d),
    enabled=False -> None."""
    if d is True:
        d = DistillSpec()
    elif d is False:
        d = None
    elif isinstance(d, dict):
        d = DistillSpec(**d)
    if d is not None and not d.enabled:
        d = None
    return d
