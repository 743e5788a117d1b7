"""The comparison that decides `correct`: the program's sampled steps held
against the plain reference, stage by stage.

The program's step is a chain (scene -> oracle -> detector -> controller
-> learning), and its state at a step is the program's own: the
reference takes each sampled step's inputs (the controller state, the
scene and, distilling, the learning state the program carried into the
step), works out every stage again, and compares what the program
produced:

  start           the program's initial controller and scene state (and
                  learned heads) against the reference's own from the
                  seed: mismatching elements (floats: past a few ulps)
  scene           the scene state after the step: mismatching elements
  oracle          acc_true of every window: mismatching elements
  detector        the detector's top-k scores on every shortlisted crop
                  (crop_patchify's tokens through the configured
                  model, its neck and heads): worst absolute gap
  tables          the observation tables the program made from its
                  detections, against the reference's tables from the
                  same detections: mismatching elements
  controller      the step's outputs and next controller state, the
                  reference's fleet_step run on the program's
                  observations: mismatching elements
  learn_loss      distilling: the per-camera loss of the update, worst
                  relative gap
  learn_update    distilling: the heads' change, worst leaf, as the gap
                  of the update's norms against the reference's norm
                  of that leaf or of the median leaf

The program's observation tables and the detections they were made from
come from its provider's `observe` run again on the step's inputs (the
program is deterministic: the controller check, which feeds the tables
to the reference's fleet_step and compares with what the window's step
produced, shows they are the window's). `control=True` also computes
the detector and learning stages a second time in the reference with
TF32-rounded products, the numbers the lower-precision control gives in
the program's place.
"""
from __future__ import annotations

import torch

from bench.reference import episode as ref
from bench.reference.layers import full_float32, tf32_products
from bench.reference.scene import SceneState

# a float element "matches" within a few float32 ulps: the budget walk's
# kernel sums a path's time in another order than its plain version
# (path_time 1 ulp apart); every other float compared is bit-equal
ULPS_RTOL = 1e-6


def _find(tree, fields: tuple):
    """The first NamedTuple in a (nested) tuple carry with all `fields`."""
    if hasattr(tree, "_fields"):
        if all(f in tree._fields for f in fields):
            return tree
        return None
    if isinstance(tree, (tuple, list)):
        for t in tree:
            found = _find(t, fields)
            if found is not None:
                return found
    return None


def _leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [leaf for t in x for leaf in _leaves(t)]
    return []


def mismatches(got, want) -> int:
    """Elements of `got` that differ from `want` (both NamedTuples of
    tensors; `want`'s fields, by name): integers and flags unequal,
    floats more than ULPS_RTOL apart relative to `want`'s. NaN equals
    NaN."""
    n = 0
    for name in want._fields:
        for g, w in zip(_leaves(getattr(got, name)),
                        _leaves(getattr(want, name))):
            g = g.to(w.device)
            if g.shape != w.shape:
                n += w.numel()
                continue
            same = g == w
            if w.is_floating_point():
                same = (same | (torch.isnan(g) & torch.isnan(w))
                        | ((g - w).abs() <= ULPS_RTOL * w.abs()))
            n += int((~same).sum())
    return n


def score_gap(got, want, widx: torch.Tensor) -> float:
    """Worst gap of the top-k detection scores (sorted, in [0, 1]) over
    the shortlisted (camera, window) crops; got/want leaves [F, C, k]."""
    idx = widx[..., None].expand(-1, -1, want.shape[-1])
    g = torch.gather(got.to(want.device), 1, idx)
    return float((g - torch.gather(want, 1, idx)).abs().max())


def loss_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst per-camera relative gap of the update's loss (-1.0 marks a
    camera that did not update; a camera that updated on one side only
    reads 1)."""
    got, want = got.to(want.device).double(), want.double()
    upd_g, upd_w = got >= 0, want >= 0
    if bool((upd_g != upd_w).any()):
        return 1.0
    if not bool(upd_w.any()):
        return 0.0
    gap = (got - want).abs() / want.abs().clamp(min=1e-12)
    return float(gap[upd_w].max())


def update_gap(before, got, want) -> float:
    """Worst leaf's gap between the norms of the program's and the
    reference's change of the heads, against the reference's norm of
    that leaf's change or of the median leaf's, whichever is larger."""
    b, g, w = _leaves(before), _leaves(got), _leaves(want)
    dg = [(x.to(y.device) - y0).double().norm() for x, y, y0 in
          zip(g, w, b)]
    dw = [(y - y0).double().norm() for y, y0 in zip(w, b)]
    med = torch.stack(dw).median()
    gaps = [(a - c).abs() / torch.maximum(c, med).clamp(min=1e-30)
            for a, c in zip(dg, dw)]
    return float(torch.stack(gaps).max())


def start_mismatches(run, world, weights) -> int:
    """The program's initial state against the reference's own."""
    state, carry = run.fresh()
    sc = _find(carry, SceneState._fields)
    n = mismatches(state, world.state0) + mismatches(sc, world.scene0)
    if world.distill is not None:
        lc = _find(carry, ("params", "opt", "buf", "staged"))
        n += sum(int((a.to(b.device) != b).sum()) for a, b in zip(
            _leaves(lc.params), _leaves(ref.initial_learn(
                world, weights).params)))
    return n


def check_step(run, world, weights, s, control: bool = False) -> dict:
    """Every number of one sampled step (and, with `control`, the
    control's detector and learning numbers under "control_*")."""
    state, carry = s.inp
    state2, carry2, out, ex = s.res
    sc_in = _find(carry, SceneState._fields)
    sc_out = _find(carry2, SceneState._fields)
    nums = {}
    carry_obs, obs, dets = run.replay_observe(s)
    sc1 = ref.advance(world, state, sc_in)
    nums["scene"] = mismatches(sc_out, sc1)
    acc_true = ref.oracle(world, state, sc1)
    nums["oracle"] = int((obs.acc_true.to(acc_true.device)
                          != acc_true).sum())
    heads = None
    lc_in = lc_obs = lc_out = None
    if world.distill is not None:
        fields = ("params", "opt", "buf", "staged")
        lc_in, lc_obs, lc_out = (_find(c, fields)
                                 for c in (carry, carry_obs, carry2))
        heads = lc_in.params
    _, widx, want_dets = ref.detect(world, weights, state, sc1, acc_true,
                                    heads)
    if dets is None:
        raise RuntimeError("the program's detections were not seen: its "
                           "provider no longer calls fleet.runner"
                           ".detections_obs once a step")
    nums["detector"] = score_gap(dets.scores, want_dets.scores, widx)
    nums["tables"] = mismatches(obs, ref.tables(world, dets, obs.acc_true))
    state2_ref, out_ref = ref.control(world, state, obs)
    nums["controller"] = (mismatches(out, out_ref)
                          + mismatches(state2, state2_ref))
    if world.distill is not None:
        lc_ref, loss_ref = ref.learn(world, lc_obs, state2, out, sc1, s.e)
        nums["learn_loss"] = loss_gap(ex["learn"]["loss"], loss_ref)
        nums["learn_update"] = update_gap(lc_in.params, lc_out.params,
                                          lc_ref.params)
    if control:
        with tf32_products():
            _, _, ctl_dets = ref.detect(world, weights, state, sc1,
                                        acc_true, heads)
        nums["control_detector"] = score_gap(ctl_dets.scores,
                                             want_dets.scores, widx)
        if world.distill is not None:
            with tf32_products():
                lc_ctl, loss_ctl = ref.learn(world, lc_obs, state2, out,
                                             sc1, s.e)
            nums["control_learn_loss"] = loss_gap(loss_ctl, loss_ref)
            nums["control_learn_update"] = update_gap(
                lc_in.params, lc_ctl.params, lc_ref.params)
    return nums


def compare(run, world, weights, sampled, control: bool = False
            ) -> tuple[dict, list]:
    """(the worst reading of each number over the sampled steps, each
    step's readings); the start's number rides with every step."""
    with full_float32(), torch.no_grad():
        start = start_mismatches(run, world, weights)
        per_step = [{"start": start, **check_step(run, world, weights, s,
                                                  control)}
                    for s in sampled]
    worst = {}
    for nums in per_step:
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
    return worst, per_step


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) over the numbers that have
    a limit; a number past its limit, or a limit with no number, fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or value > limit:
            ok = False
    return ok, checks
