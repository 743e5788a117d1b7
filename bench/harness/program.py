"""The system under test: the port's fleet with the cell's configured
model, prepared from a cell and driven step by step through a timed
window.

Set-up is `repro_torch.fleet.api.prepare_fleet_run` and one untimed
warm-up step on a fresh state (as `run_fleet` takes one). The window
calls `repro_torch.fleet.runner.episode_step` step after step, inside
`full_float32()` and `torch.no_grad()`, as `run_fleet` does; each step
ends when its decisions (`chosen` [F] and the `sent` mask) are on the
host. A seeded reservoir keeps the inputs and outputs of a few steps
(and always of the last) for the comparison; holding them costs no
copy, since every step returns new tensors.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import torch

# steps a run may take per second of its window (a step takes tens of
# milliseconds or more), and steps kept for after the window
STEPS_PER_SECOND_MAX = 1000
SPARE_STEPS = 200
N_SAMPLED = 2               # reservoir of earlier steps; the last is added


@dataclass
class Step:
    e: int
    inp: tuple              # (state, carry) before step e
    res: tuple              # (state', carry', out, extras) of step e


@dataclass
class Window:
    steps: int = 0
    seconds: float = 0.0
    step_s: list = field(default_factory=list)
    sampled: list = field(default_factory=list)


class Run:
    """The program prepared for one cell and seed on `device`."""

    def __init__(self, cell, weights, seed: int, seconds: float, device):
        from repro_torch.fleet.api import FleetRunSpec, prepare_fleet_run
        from repro_torch.learn.spec import DistillSpec
        from repro_torch.scene.scene import SceneSpec

        t = cell.traffic
        s = cell.sizes
        provider, model_kwargs = cell.model.program(s)
        n_steps = int(STEPS_PER_SECOND_MAX * seconds) + SPARE_STEPS
        spec = FleetRunSpec(
            provider=provider, n_cameras=t["n_cameras"], n_steps=n_steps,
            seed=seed, workload=tuple(tuple(q) for q in t["workload"]),
            budget={"fps": t["fps"]}, grid=dict(t["grid"]),
            shortlist_k=t["shortlist_k"],
            distill=(None if cell.distill is None
                     else DistillSpec(**cell.distill)),
            provider_kwargs={
                **model_kwargs, "det_params": weights,
                "thresh": s.score_thresh, "noise": t["render_noise"],
                "mbps": t["network"]["mbps"],
                "rtt_ms": t["network"]["rtt_ms"],
                "spec": SceneSpec(**t["scene"])})
        self.device = torch.device(device)
        self.prep = prepare_fleet_run(spec, device=device)
        self.seed = seed
        self.e = 0

    # -- the program's entry --------------------------------------------
    def step(self, state, carry, e: int):
        from repro_torch.fleet.runner import episode_step
        p = self.prep
        if e >= p.provider.n_steps:
            raise RuntimeError(
                f"the window ran past the {p.provider.n_steps} steps the "
                f"fleet was prepared for")
        return episode_step(p.cfg, p.wl, p.statics, state, p.provider,
                            carry, e)

    def fresh(self):
        """The initial (state, carry)."""
        return self.prep.state, self.prep.provider.init_carry(
            self.prep.state)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self):
        """One step on a fresh state, its result discarded."""
        self.step(*self.fresh(), 0)
        self.sync()

    def window(self, seconds: float) -> Window:
        """Steps from the initial state until `seconds` have passed."""
        rng = random.Random(self.seed)
        w = Window()
        state, carry = self.fresh()
        reservoir: list = []
        last = None
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            e = self.e
            inp = (state, carry)
            state, carry, out, ex = self.step(state, carry, e)
            out.chosen.cpu()
            out.sent.cpu()
            t1 = time.perf_counter()
            w.step_s.append(t1 - t0)
            if last is not None:
                if len(reservoir) < N_SAMPLED:
                    reservoir.append(last)
                else:
                    j = rng.randrange(last.e + 1)
                    if j < N_SAMPLED:
                        reservoir[j] = last
            last = Step(e, inp, (state, carry, out, ex))
            self.e += 1
            if t1 - t_start >= seconds:
                break
        w.steps = len(w.step_s)
        w.seconds = t1 - t_start
        w.sampled = sorted(reservoir, key=lambda s: s.e) + [last]
        self.state, self.carry = state, carry
        return w

    def more(self, n: int):
        """n further steps after the window, from where it stopped."""
        for _ in range(n):
            self.state, self.carry, out, _ = self.step(
                self.state, self.carry, self.e)
            out.chosen.cpu()
            out.sent.cpu()
            self.e += 1

    def replay_observe(self, s: Step):
        """The provider's observation of step s, computed again from the
        step's own inputs: (carry after observe, FleetObs, the detections
        the tables were made from). The detections are read where the
        provider hands them to `repro_torch.fleet.runner.detections_obs`
        (None where it does not call it)."""
        from repro_torch.fleet import runner

        p = self.prep
        state, carry = s.inp
        xs = tuple(x[s.e] for x in p.provider.scan_xs())
        seen = []
        real = getattr(runner, "detections_obs", None)

        def record(dets, *args, **kwargs):
            seen.append(dets)
            return real(dets, *args, **kwargs)

        if real is not None:
            runner.detections_obs = record
        try:
            carry, obs = p.provider.observe(p.cfg, p.wl, carry, state, xs)
        finally:
            if real is not None:
                runner.detections_obs = real
        return carry, obs, (seen[0] if len(seen) == 1 else None)

    def free(self):
        self.prep = self.state = self.carry = None
