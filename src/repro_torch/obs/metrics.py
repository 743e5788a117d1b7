"""In-episode device metrics: a per-step FleetMetrics dict from inside the
episode loop.

MadEye's accuracy is governed by decisions the step outputs alone can't
explain: did the search shortlist contain the oracle-best orientation
(paper §3.3)? how far does the distilled detector's ranking drift from
the teacher's (§3.4)? is the budget sending what it planned?
`step_metrics` answers those from tensors already on the device — a
handful of [F, N] reductions per step, no read-back to the host.

Gating: a static `MetricsSpec` rides `FleetRunSpec.metrics`.
`metrics=None` / `enabled=False` runs the exact metrics-free episode;
decisions are bit-identical either way.

Emitted keys (each a per-step [F] tensor, stacked to [E, F]; `METRIC_KEYS`
maps the MetricsSpec flag that owns each group):

  ewma_label_mean   mean EWMA search label over visited cells
  frames_sent       frames actually shipped this step (sum of `sent`)
  k_send            the budget's planned send count
  n_explored        search cells visited this step
  cells_visited     distinct cells ever visited (exploration coverage)
  shortlist_hit     1.0 when the oracle-best cell (argmax of acc_true
                    over all N*Z windows) is in the candidate shortlist
                    this step — always 1.0 for exhaustive providers
  chosen_rank       1-based oracle-accuracy rank of the chosen
                    orientation among the explored cells at their chosen
                    zooms; 0 on degenerate steps (<2 explored cells or
                    an all-zero oracle row)
  score_mean        mean predicted accuracy over explored cells
  score_max         max predicted accuracy over explored cells

Learning runs add `distill_loss` and `distill_lr` (fleet/runner.py).
`chosen_rank` is how distillation's effect is read (converging toward
1 == the detector ranks like the teacher).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# flag on MetricsSpec -> the FleetMetrics keys it owns
METRIC_KEYS = {
    "ewma": ("ewma_label_mean",),
    "budget": ("frames_sent", "k_send", "n_explored", "cells_visited"),
    "shortlist": ("shortlist_hit",),
    "rank": ("chosen_rank", "score_mean", "score_max"),
}


@dataclass(frozen=True)
class MetricsSpec:
    """Static gate for in-episode metrics, field for field the reference
    package's.

    The default `MetricsSpec()` turns everything on; flags drop metric
    groups entirely (nothing is computed for a disabled group).
    `enabled=False` is equivalent to passing no spec at all."""
    enabled: bool = True
    ewma: bool = True
    budget: bool = True
    shortlist: bool = True
    rank: bool = True

    def keys(self) -> tuple:
        if not self.enabled:
            return ()
        return tuple(k for flag, keys in METRIC_KEYS.items()
                     if getattr(self, flag) for k in keys)


def normalize_metrics(m) -> MetricsSpec | None:
    """The FleetRunSpec normalization rule: True -> MetricsSpec(),
    False/None -> None, dict -> MetricsSpec(**d), enabled=False ->
    None."""
    if m is True:
        m = MetricsSpec()
    elif m is False:
        m = None
    elif isinstance(m, dict):
        m = MetricsSpec(**m)
    if m is not None and not m.enabled:
        m = None
    return m


def step_metrics(spec: MetricsSpec, cfg, provider, state_pre, state_post,
                 obs, out) -> dict:
    """One step's FleetMetrics — a {name: [F] tensor} dict.

    Runs after `fleet_step`: `state_pre` is the controller state the
    provider observed with (the shortlist is a pure function of it, so
    the candidate set is recomputed here bit-identically),
    `state_post`/`out` are fleet_step's results, `obs` this step's
    observation tables (for the oracle-best window)."""
    from repro_torch.core import ewma
    from repro_torch.fleet.state import NEVER_VISITED
    from repro_torch.fleet.step import gather_at_zoom

    m: dict[str, torch.Tensor] = {}
    f, n = out.explored.shape
    arange_f = torch.arange(f, device=out.explored.device)

    if spec.ewma:
        lab = ewma.labels(state_post.ewma, delta_weight=cfg.delta_weight)
        seen = state_post.ewma.seen > 0
        m["ewma_label_mean"] = (torch.where(seen, lab, 0.0).sum(-1)
                                / torch.clamp(seen.sum(-1), min=1))

    if spec.budget:
        m["frames_sent"] = out.sent.sum(-1)
        m["k_send"] = out.k_send
        m["n_explored"] = out.n_explored
        m["cells_visited"] = torch.sum(
            state_post.last_visit > NEVER_VISITED, -1)

    if spec.shortlist:
        z = len(cfg.zoom_levels)
        c = n * z
        acc = obs.acc_true.expand(f, n, z)
        best_cell = torch.argmax(acc.reshape(f, c), dim=-1) // z
        k = getattr(provider, "shortlist_k", 0)
        if 0 < k < c:
            from repro_torch.fleet.runner import shortlist_windows

            widx = shortlist_windows(cfg, state_pre, provider.nbr8, k)
            kept = widx[:, ::z] // z                    # [F, K/Z] cells
            hit = torch.any(kept == best_cell[:, None], dim=-1)
        else:
            hit = torch.ones((f,), dtype=torch.bool,
                             device=out.explored.device)
        m["shortlist_hit"] = hit.float()

    if spec.rank:
        true_g = gather_at_zoom(obs.acc_true, out.zooms)     # [F, N]
        chosen_val = true_g[arange_f, out.chosen]
        mx = torch.where(out.explored, true_g, -torch.inf).amax(-1)
        valid = (out.n_explored >= 2) & (mx > 0)
        rank = 1 + torch.sum(
            out.explored & (true_g > chosen_val[:, None]), -1)
        m["chosen_rank"] = torch.where(valid, rank, 0)
        pred = torch.where(out.explored, out.pred_acc, 0.0)
        kf = torch.clamp(out.n_explored, min=1).float()
        m["score_mean"] = pred.sum(-1) / kf
        m["score_max"] = pred.amax(-1)

    return m


# ---------------------------------------------------------------------------
# host-side reductions over the emitted [E, F] metrics
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def median_valid_rank(chosen_rank) -> float:
    """Median of the non-degenerate chosen-rank entries (0 = the step
    was degenerate and is excluded); 0.0 when no step was gradable."""
    r = _host(chosen_rank).reshape(-1)
    r = r[r > 0]
    return float(np.median(r)) if r.size else 0.0


def summarize_metrics(metrics: dict) -> dict:
    """Reduce stacked [E, F] FleetMetrics to a JSON-native per-camera
    summary dict."""
    m = {k: _host(v) for k, v in metrics.items()}
    out: dict = {}
    if "ewma_label_mean" in m:
        out["ewma_label_final"] = m["ewma_label_mean"][-1].tolist()
    if "frames_sent" in m:
        out["frames_sent_total"] = m["frames_sent"].sum(0).tolist()
        out["frames_budget_total"] = m["k_send"].sum(0).tolist()
        out["cells_visited_final"] = m["cells_visited"][-1].tolist()
        out["mean_explored"] = m["n_explored"].mean(0).tolist()
    if "shortlist_hit" in m:
        out["shortlist_hit_rate"] = m["shortlist_hit"].mean(0).tolist()
    if "chosen_rank" in m:
        out["chosen_rank_median"] = [
            median_valid_rank(m["chosen_rank"][:, fi])
            for fi in range(m["chosen_rank"].shape[1])]
        out["score_mean"] = m["score_mean"].mean(0).tolist()
    if "distill_loss" in m:
        # learning runs only: mean loss per camera over the steps it
        # actually updated (-1.0 marks off-cadence/idle)
        loss = m["distill_loss"]
        upd = loss >= 0.0
        n = np.maximum(upd.sum(0), 1)
        out["distill_loss_mean"] = np.where(
            upd.any(0), (loss * upd).sum(0) / n, -1.0).tolist()
        out["distill_update_steps"] = upd.sum(0).tolist()
        out["distill_lr_final"] = m["distill_lr"][-1].tolist()
    return out
