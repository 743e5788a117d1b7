"""A run with the timed path broken underneath comes out not correct,
for each fault a cell of this system can have: a step that returns its
state unchanged, half of the batch left out of the detector, an answer
altered where it is produced. (The cells run on one card: no exchange
between cards exists to leave out.)"""
from __future__ import annotations

import pytest
import torch

from conftest import run_smoke


def _unchanged(real):
    def step(cfg, wl, statics, state, provider, carry, e, **kw):
        _, _, out, ex = real(cfg, wl, statics, state, provider, carry, e,
                             **kw)
        return state, carry, out, ex
    return step


def _half_batch(real):
    def forward(params, cfg, tokens):
        dets = real(params, cfg, tokens)
        keep = torch.arange(tokens.shape[0]) < tokens.shape[0] // 2
        return type(dets)(*(torch.where(
            keep.reshape((-1,) + (1,) * (x.dim() - 1)), x,
            torch.zeros_like(x)) for x in dets))
    return forward


def _altered(real):
    def step(cfg, wl, statics, state, obs):
        state2, out = real(cfg, wl, statics, state, obs)
        n = obs.counts.shape[1]
        chosen = out.chosen.clone()
        chosen[0] = (chosen[0] + 1) % n
        return state2, out._replace(chosen=chosen)
    return step


@pytest.mark.parametrize("target,fault", [
    ("episode_step", _unchanged),
    ("detector_forward_tokens", _half_batch),
    ("fleet_step", _altered)])
def test_fault_is_caught(smoke_root, monkeypatch, target, fault):
    from repro_torch.fleet import runner

    monkeypatch.setattr(runner, target, fault(getattr(runner, target)))
    res, lines = run_smoke(smoke_root, "smoke-approx", seconds=0.5)
    assert not res["correct"], lines
    assert res["failed"] > 0


def test_distill_half_batch_is_caught(smoke_root, monkeypatch):
    from repro_torch.fleet import runner

    real = runner.detector_neck_feats_tokens

    def feats(params, cfg, tokens):
        x = real(params, cfg, tokens)
        keep = torch.arange(x.shape[0]) < x.shape[0] // 2
        return torch.where(keep[:, None, None, None], x, 0.0)

    monkeypatch.setattr(runner, "detector_neck_feats_tokens", feats)
    res, lines = run_smoke(smoke_root, "smoke-distill", seconds=0.5)
    assert not res["correct"], lines
