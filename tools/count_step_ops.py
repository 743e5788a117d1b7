"""Count the PyTorch operations one controller step dispatches, by phase.

    PYTHONPATH=src python tools/count_step_ops.py [--device cpu|cuda]
        [--cameras 64] [--steps 3]

Drives run_fleet(FleetRunSpec(provider="scene")) with a dispatch-mode
counter on and splits the ops of one step by phase: the scene advance
(advance_scene), the oracle pass (observe_all_cells) and, inside
fleet_step, the shape search (shape_search_batch: evolve + resize), the
budget walk (budget_walk_batch: shrink to the time budget) and the rest
of the step. Prints the mean per step (warm-up step included) as one
JSON line. On CPU tensors the oracle pass and the two searches run their
plain versions (what the card ran before they became kernels); on the
card each is one kernel launch (through ctypes, not a PyTorch op) plus
its output allocations.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path

from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.fleet import runner, step  # noqa: E402
from repro_torch.fleet.api import FleetRunSpec, run_fleet  # noqa: E402


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched while `phase` is set, by phase."""

    def __init__(self):
        super().__init__()
        self.phase = None
        self.counts = Counter()
        self.steps = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.phase:
            self.counts[self.phase] += 1
        return func(*args, **(kwargs or {}))

    def in_phase(self, phase, fn):
        def wrapped(*args, **kwargs):
            outer, self.phase = self.phase, phase
            try:
                return fn(*args, **kwargs)
            finally:
                self.phase = outer
        return wrapped


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--cameras", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args()
    counter = OpCounter()
    saved = (runner.fleet_step, step.shape_search_batch,
             step.budget_walk_batch, runner.advance_scene,
             runner.observe_all_cells)

    def counted_step(*args, **kwargs):
        counter.steps += 1
        return counter.in_phase("rest", saved[0])(*args, **kwargs)

    runner.fleet_step = counted_step
    step.shape_search_batch = counter.in_phase("shape_search", saved[1])
    step.budget_walk_batch = counter.in_phase("budget_walk", saved[2])
    runner.advance_scene = counter.in_phase("scene_advance", saved[3])
    runner.observe_all_cells = counter.in_phase("oracle", saved[4])
    try:
        with counter:
            run_fleet(FleetRunSpec(provider="scene", n_cameras=a.cameras,
                                   n_steps=a.steps), device=a.device)
    finally:
        (runner.fleet_step, step.shape_search_batch, step.budget_walk_batch,
         runner.advance_scene, runner.observe_all_cells) = saved
    per_step = {k: v / counter.steps for k, v in counter.counts.items()}
    print(json.dumps({"device": a.device, "cameras": a.cameras,
                      "fleet_step_calls": counter.steps,
                      "ops_per_step": per_step,
                      "total_per_step": sum(per_step.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
