"""Batched detector inference, the fleet-wide EWMA ranking helpers and
the three fleet-controller shims.

Every explored orientation of every camera is one row of a single
[B, H, W, 3] batch, scored by one detector forward (`InferenceEngine`,
`detector_scores`); the ranking state (EWMA labels) is a [C, N] batch
over C cameras (core/ewma.py), and `fleet_step` ranks, updates and picks
the frames to send for the whole fleet in one call. The EWMA-only
helpers serve pipelines that rank on the server side without the
camera-side shape search; `run_fleet_*_controller` drive the full
controller (repro_torch.fleet) through the experiment API.

Ties in every top-k go to the lower index (a stable descending sort).
Entry points that make tensors run on the CUDA card unless the caller
passes `device="cpu"`; without a card they raise.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs import DetectorConfig
from repro_torch.core import ewma
from repro_torch.fleet.api import FleetRunSpec, prepare_fleet_run
from repro_torch.fleet.runner import resolve_device
from repro_torch.models import detector as det
from repro_torch.models.layers import full_float32


# images [B, H, W, 3] -> Detections ([B, max_boxes, ...])
detector_scores = det.detector_forward
# patch-embedding tokens [B, P, D] -> Detections: the fused path's one
# batched forward over its [F*K] shortlisted crops
detector_scores_tokens = det.detector_forward_tokens


def detector_counts_and_areas(params, cfg: DetectorConfig,
                              images: torch.Tensor, score_thresh):
    """-> (counts [B], areas [B]) of the detections scoring at least
    `score_thresh`, for rank.py consumption."""
    d = det.detector_forward(params, cfg, images)
    keep = d.scores >= score_thresh
    counts = keep.sum(-1)
    areas = (d.boxes[..., 2] * d.boxes[..., 3] * keep).sum(-1)
    return counts, areas


@dataclass
class InferenceEngine:
    """Detector inference over orientation batches on `device` (the CUDA
    card unless "cpu"; each forward with TF32 off, as run_fleet runs
    it). `params` (tensors or arrays) are moved to the device once."""
    cfg: DetectorConfig
    params: dict
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.params = det.params_from_numpy(self.params, self.device)

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images, dtype=torch.float32,
                               device=self.device)

    def score_batch(self, images) -> det.Detections:
        """images [B, H, W, 3] -> Detections ([B, max_boxes, ...])."""
        with torch.no_grad(), full_float32():
            return detector_scores(self.params, self.cfg,
                                   self._images(images))

    def counts_and_areas(self, images, *, score_thresh: float = 0.5):
        """-> (counts [B], areas [B]) for rank.py consumption."""
        with torch.no_grad(), full_float32():
            return detector_counts_and_areas(
                self.params, self.cfg, self._images(images), score_thresh)


# ---------------------------------------------------------------------------
# fleet-scale EWMA ranking state ([C, N] over C cameras)
# ---------------------------------------------------------------------------

# state leaves [C, N]; visited / acc_values [C, N]
fleet_update_labels = ewma.update
fleet_labels = ewma.labels


def init_fleet_state(n_cameras: int, n_cells: int,
                     device=None) -> ewma.EWMAState:
    z = torch.zeros((n_cameras, n_cells), dtype=torch.float32,
                    device=resolve_device(device))
    return ewma.EWMAState(z, z, z, z)


def fleet_topk_cells(labels: torch.Tensor, k: int = 4):
    """labels [C, N] -> (values [C, k], cells [C, k]): per-camera
    ranking, ties toward the lower cell."""
    values, cells = torch.sort(labels, dim=-1, descending=True, stable=True)
    return values[:, :k], cells[:, :k]


def fleet_step(state: ewma.EWMAState, counts: torch.Tensor,
               areas: torch.Tensor, visited: torch.Tensor, *,
               k_send: int = 2):
    """One fleet-wide ranking timestep: the count task's relative scoring
    (core/rank.py), the EWMA label update and the top-k cells to send.

    counts / areas [C, N] — approximation-model outputs for the explored
    cells of every camera (zeros elsewhere); visited [C, N] bool.
    Returns (new_state, send_cells [C, k_send], pred_acc [C, N]).
    Unexplored cells rank as -inf, so when k_send exceeds a camera's
    explored count its remaining picks are its lowest unexplored cells.
    """
    cmax = torch.where(visited, counts, 0.0).amax(1, keepdim=True)
    cscore = torch.where(cmax > 0, counts / torch.clamp(cmax, min=1e-9),
                         0.0)
    amax = torch.where(visited, areas, 0.0).amax(1, keepdim=True)
    ascore = torch.where(amax > 0, areas / torch.clamp(amax, min=1e-9),
                         0.0)
    pred = torch.where(visited, 0.7 * cscore + 0.3 * ascore, 0.0)
    new_state = ewma.update(state, visited, pred)
    _, cells = fleet_topk_cells(
        torch.where(visited, pred, -torch.inf), k_send)
    return new_state, cells, pred


# ---------------------------------------------------------------------------
# fleet-controller shims over the experiment API (repro_torch.fleet.api):
# each builds a FleetRunSpec for its provider and returns the episode's
# (final FleetState, FleetStepOut stacked over steps), plus (extras,
# final carry) on learning runs. New code should call run_fleet.
# ---------------------------------------------------------------------------

def _controller_episode(spec: FleetRunSpec, mesh, device):
    """The episode of `spec`, split over `mesh`'s data ranks when one is
    given (every rank of it calls this; each returns the whole fleet's
    outputs)."""
    prep = prepare_fleet_run(spec, mesh=mesh, device=device)
    with torch.no_grad(), full_float32():
        state, out, ex, carry = prep.episode()
    if getattr(prep.provider, "learns", False):
        return state, out, ex, carry
    return state, out


def run_fleet_controller(video, workload, tables, budget, trace, *,
                         n_cameras: int, mesh=None,
                         approx_miss: float = 0.12,
                         acc_table=None, max_steps: int | None = None,
                         device=None):
    """Fleet controller on a prebuilt host serving substrate (the
    many-camera analogue of pipeline.run_madeye): the `tables` provider
    with the prebuilt video / tables / trace riding through its kwargs.
    Returns (final FleetState, FleetStepOut stacked over steps)."""
    spec = FleetRunSpec.from_objects(
        "tables", n_cameras=n_cameras, n_steps=max_steps,
        grid=video.grid, workload=workload, budget=budget,
        video=video, tables=tables, trace=trace, acc_table=acc_table,
        approx_miss=approx_miss)
    return _controller_episode(spec, mesh, device)


def run_fleet_scene_controller(grid, workload, budget, *, n_cameras: int,
                               n_steps: int, mesh=None, seed: int = 0,
                               device=None, **scene_kwargs):
    """Fleet controller on the per-camera scene substrate (the `scene`
    provider); `scene_kwargs` go to fleet.make_scene_provider (scalars
    broadcast, [F] arrays give per-camera heterogeneity). Returns (final
    FleetState, FleetStepOut stacked over steps)."""
    spec = FleetRunSpec.from_objects(
        "scene", n_cameras=n_cameras, n_steps=n_steps, seed=seed,
        grid=grid, workload=workload, budget=budget, **scene_kwargs)
    return _controller_episode(spec, mesh, device)


def run_fleet_detector_controller(grid, workload, budget, *,
                                  n_cameras: int, n_steps: int, mesh=None,
                                  seed: int = 0, det_cfg=None,
                                  det_params=None, distill=None,
                                  device=None, **scene_kwargs):
    """Fleet controller with the approximation model in the loop (the
    `detector` provider, paper §3.4). det_cfg defaults to the
    madeye-approx smoke config; det_params are drawn from `seed` when
    not given (a params tree or a `.npz` path selects a trained camera).
    `distill` (True / DistillSpec / dict) turns on in-episode
    distillation, and the return grows the (extras, final carry) tail of
    fleet.run_fleet_episode. `scene_kwargs` go to
    fleet.make_detector_provider. Returns (final FleetState,
    FleetStepOut stacked over steps) on frozen runs."""
    scene_kwargs.setdefault("det_seed", seed)
    spec = FleetRunSpec.from_objects(
        "detector", n_cameras=n_cameras, n_steps=n_steps, seed=seed,
        grid=grid, workload=workload, budget=budget,
        det_cfg=det_cfg, det_params=det_params, distill=distill,
        **scene_kwargs)
    return _controller_episode(spec, mesh, device)
