"""Fleet experiment API: one declarative entry for every provider.

  * the provider registry — string-keyed factories (`tables`, `scene`,
    `detector`) with one uniform signature, open through
    `register_provider`;
  * `FleetRunSpec` — a JSON-round-trippable description of a fleet
    experiment, field for field the reference package's, so one spec
    JSON names the same run in both packages;
  * `run_fleet(spec, device=None) -> FleetResult` — build the provider,
    run one warm-up step (kernel build and load included, timed as
    `compile_s`), then the episode (timed as `steady_s`); with a tracer
    active (repro_torch.obs.trace) the three phases are the spans
    `fleet/build`, `fleet/compile` and `fleet/steady`.

    >>> spec = FleetRunSpec(provider="detector", n_cameras=4, n_steps=8)
    >>> result = run_fleet(spec)           # on the CUDA card
    >>> result.accuracy, result.frames_sent[-1]

`metrics` turns on the in-episode FleetMetrics (`result.metrics`) and
`distill` the in-episode distillation of the detector (`result
.distill_loss`, `result.learned_params(camera)`).

Entry points run on `cuda` unless the caller passes `device="cpu"`;
without a card they raise rather than fall back to the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import DEFAULT_GRID, OrientationGrid, Query, Workload
from repro_torch.core.tradeoff import BudgetConfig
from repro_torch.fleet.runner import (
    episode_step,
    make_detector_provider,
    make_scene_provider,
    make_tables_provider,
    resolve_device,
    run_fleet_episode,
    save_detector_params,
)
from repro_torch.fleet.state import (
    FleetConfig,
    FleetState,
    FleetStatics,
    WorkloadSpec,
    fleet_config,
    fleet_statics,
    workload_spec,
)
from repro_torch.fleet.step import FleetStepOut
from repro_torch.learn.spec import DistillSpec, normalize_distill
from repro_torch.obs.metrics import MetricsSpec, normalize_metrics
from repro_torch.obs.trace import span

# the serving launcher's default 4-query workload, as (model, object,
# task) triples
DEFAULT_QUERIES = (
    ("yolov4", "person", "count"),
    ("ssd", "car", "detect"),
    ("frcnn", "person", "binary"),
    ("tiny-yolov4", "person", "agg_count"),
)


# ---------------------------------------------------------------------------
# provider registry
# ---------------------------------------------------------------------------

# factory signature: (grid, workload, cfg, *, n_cameras, n_steps, seed,
# device, **kwargs) -> (provider, FleetState)
ProviderFactory = Callable[..., tuple]

_PROVIDERS: dict[str, ProviderFactory] = {}


def register_provider(name: str, factory: ProviderFactory) -> None:
    """Register an observation-provider factory under a spec name."""
    _PROVIDERS[name] = factory


def provider_factory(name: str) -> ProviderFactory:
    if name not in _PROVIDERS:
        raise KeyError(
            f"unknown observation provider {name!r}; available: "
            f"{', '.join(sorted(_PROVIDERS))}")
    return _PROVIDERS[name]


def available_providers() -> tuple[str, ...]:
    return tuple(sorted(_PROVIDERS))


register_provider("tables", make_tables_provider)
register_provider("scene", make_scene_provider)
register_provider("detector", make_detector_provider)


# ---------------------------------------------------------------------------
# declarative run specification
# ---------------------------------------------------------------------------

def _jsonable(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    raise TypeError(f"{type(x).__name__} is not JSON-serializable")


@dataclass(frozen=True)
class FleetRunSpec:
    """Everything that defines one fleet experiment, declaratively; the
    same fields and JSON as the reference package's spec."""
    provider: str = "scene"
    n_cameras: int = 4
    n_steps: int | None = 32
    seed: int = 0
    workload: tuple = DEFAULT_QUERIES   # ((model, obj, task), ...)
    budget: dict = field(default_factory=dict)  # BudgetConfig overrides
    grid: dict = field(default_factory=dict)    # OrientationGrid overrides
    provider_kwargs: dict = field(default_factory=dict)
    # mesh placement of the fleet axis, as the reference's ShardSpec
    # fields (not ported: only None or kind "none" runs)
    shard: dict | None = None
    # how many of the N*Z windows each camera renders + scores per step
    # (detector provider; None = exhaustive)
    shortlist_k: int | None = None
    # in-episode telemetry: None/False = off (the exact metrics-free
    # episode), True = full MetricsSpec, a dict/MetricsSpec picks metric
    # families; normalized to the dataclass so the spec JSON matches the
    # reference's
    metrics: MetricsSpec | None = None
    # in-episode distillation (paper §3.4): None/False = frozen params,
    # True = default DistillSpec, a dict/DistillSpec picks optimizer /
    # lr / cadence / ring; detector provider only
    distill: DistillSpec | None = None

    def __post_init__(self):
        object.__setattr__(
            self, "workload",
            tuple(tuple(q) for q in self.workload))
        object.__setattr__(self, "metrics", normalize_metrics(self.metrics))
        object.__setattr__(self, "distill", normalize_distill(self.distill))

    # -- object views ---------------------------------------------------
    def grid_obj(self) -> OrientationGrid:
        return OrientationGrid(**self.grid) if self.grid else DEFAULT_GRID

    def budget_obj(self) -> BudgetConfig:
        return BudgetConfig(**self.budget)

    def workload_obj(self) -> Workload:
        return Workload(tuple(Query(*q) for q in self.workload))

    @classmethod
    def from_objects(cls, provider: str, *, n_cameras: int,
                     n_steps: int | None = None, seed: int = 0,
                     grid: OrientationGrid | None = None,
                     workload: Workload | None = None,
                     budget: BudgetConfig | None = None,
                     shard: dict | None = None,
                     shortlist_k: int | None = None,
                     metrics: MetricsSpec | bool | None = None,
                     distill: Any = None,
                     **provider_kwargs) -> "FleetRunSpec":
        """Build a spec from the in-memory config objects the rest of
        the code passes around; in-memory provider kwargs (the tables
        provider's prebuilt `video`/`tables`/`trace`/`acc_table`) ride
        through `provider_kwargs` but do not survive `to_json`."""
        return cls(
            provider=provider, n_cameras=n_cameras, n_steps=n_steps,
            seed=seed,
            workload=DEFAULT_QUERIES if workload is None else tuple(
                (q.model, q.obj, q.task) for q in workload.queries),
            grid={} if grid is None else dataclasses.asdict(grid),
            budget={} if budget is None else dataclasses.asdict(budget),
            provider_kwargs=provider_kwargs, shard=shard,
            shortlist_k=shortlist_k, metrics=metrics, distill=distill)

    # -- JSON round trip ------------------------------------------------
    def to_json(self, **dumps_kwargs) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, default=_jsonable, **dumps_kwargs)

    @classmethod
    def from_json(cls, s: str) -> "FleetRunSpec":
        return cls(**json.loads(s))


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

@dataclass
class PreparedFleetRun:
    """A spec resolved to runnable pieces: provider built, configs
    derived, tensors on `device`. `episode()` runs the step loop."""
    spec: FleetRunSpec
    cfg: FleetConfig
    wl: WorkloadSpec
    statics: FleetStatics
    state: FleetState
    provider: Any
    device: torch.device
    build_s: float

    def episode(self, provider=None, state=None):
        """Run the episode with spec.metrics: `run_fleet_episode`'s
        (state, out, extras, carry)."""
        return run_fleet_episode(
            self.cfg, self.wl, self.statics,
            self.state if state is None else state,
            self.provider if provider is None else provider,
            metrics=self.spec.metrics)


def prepare_fleet_run(spec: FleetRunSpec, *, device=None
                      ) -> PreparedFleetRun:
    """Resolve a FleetRunSpec: registry lookup and provider
    construction — everything up to (but not including) the episode."""
    if spec.shard is not None and spec.shard.get("kind") != "none":
        raise NotImplementedError("sharded fleets are not ported to this "
                                  "package")
    dev = resolve_device(device)
    grid = spec.grid_obj()
    workload = spec.workload_obj()
    cfg = fleet_config(grid, spec.budget_obj())
    factory = provider_factory(spec.provider)
    kwargs = dict(spec.provider_kwargs)
    if spec.shortlist_k is not None:
        kwargs["shortlist_k"] = spec.shortlist_k
    if spec.distill is not None:
        # factories without a per-window model to train reject it
        kwargs["distill"] = spec.distill
    t0 = time.perf_counter()
    with span("fleet/build", provider=spec.provider,
              n_cameras=spec.n_cameras):
        provider, state = factory(
            grid, workload, cfg, n_cameras=spec.n_cameras,
            n_steps=spec.n_steps, seed=spec.seed, device=dev, **kwargs)
    build_s = time.perf_counter() - t0
    return PreparedFleetRun(
        spec=spec, cfg=cfg, wl=workload_spec(workload),
        statics=fleet_statics(grid, dev), state=state, provider=provider,
        device=dev, build_s=build_s)


@dataclass
class FleetResult:
    """Typed result of one fleet episode: host-side summaries
    (JSON-round-trippable) plus, from `run_fleet`, the final `state`, the
    per-step `out` (FleetStepOut, leaves [E, F, ...]), with spec.metrics
    the `metrics` dict (leaves [E, F]) and with spec.distill the
    `learned` handle; `to_json` drops those four."""
    spec: FleetRunSpec
    n_cameras: int
    n_steps: int
    accuracy: float             # mean oracle grade of chosen orientations
    acc_per_step: tuple         # [E] fleet-mean oracle accuracy
    chosen: tuple               # [E][F] chosen orientation cell ids
    frames_sent: tuple          # [E] frames shipped fleet-wide
    mean_shape: float           # mean explored-shape size
    timings: dict               # build_s, compile_s, steady_s, episode_s
    # spec.distill runs only: [E] fleet-mean distill loss over the
    # cameras that updated that step (-1.0 = off-cadence/idle step)
    distill_loss: tuple | None = None
    state: FleetState | None = None
    out: FleetStepOut | None = None
    metrics: dict | None = None
    # spec.distill runs only: (provider, final carry) — the learned
    # per-camera params live in the carry; on the device, not serialized
    learned: Any = None

    def learned_params(self, camera: int | None = 0):
        """Full detector params with camera `camera`'s learned subtree
        merged in (None keeps the leading fleet axis on trained leaves).
        Distillation runs only."""
        if self.learned is None:
            raise ValueError(
                "no learned params: run with FleetRunSpec(distill=...)")
        provider, carry = self.learned
        return provider.learned_params(carry, camera=camera)

    def save_learned_params(self, path: str, camera: int = 0) -> str:
        """Checkpoint one camera's distilled detector as a
        `save_detector_params` .npz (loadable by either package's
        `load_detector_params`, or as `det_params="..."`)."""
        return save_detector_params(path, self.learned_params(camera))

    @property
    def camera_steps_per_s(self) -> float:
        t = self.timings.get("steady_s", self.timings.get("episode_s", 0.0))
        return self.n_cameras * self.n_steps / max(t, 1e-9)

    def to_json(self, **dumps_kwargs) -> str:
        # drop the device payload before asdict, which would deep-copy it
        d = dataclasses.asdict(dataclasses.replace(
            self, state=None, out=None, metrics=None, learned=None))
        for name in ("state", "out", "metrics", "learned"):
            d.pop(name)
        d["spec"] = json.loads(self.spec.to_json())
        return json.dumps(d, default=_jsonable, **dumps_kwargs)

    @classmethod
    def from_json(cls, s: str) -> "FleetResult":
        d = json.loads(s)
        d["spec"] = FleetRunSpec(**d["spec"])
        d["acc_per_step"] = tuple(d["acc_per_step"])
        d["chosen"] = tuple(tuple(c) for c in d["chosen"])
        d["frames_sent"] = tuple(d["frames_sent"])
        if d.get("distill_loss") is not None:
            d["distill_loss"] = tuple(d["distill_loss"])
        return cls(**d)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_fleet(spec: FleetRunSpec, *, device=None) -> FleetResult:
    """THE fleet entry point: spec in, typed result out.

    Runs on the CUDA card unless `device="cpu"`. It turns TF32 off for
    float32 matrix products and cuDNN convolutions
    (torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 = False) so the detector runs in full
    float32, as the model is specified. timings["compile_s"] is one
    warm-up step on the initial state (its result discarded; the kernels
    are built and loaded there; with distillation on it takes an update
    of its own fresh LearnState), timings["steady_s"] the whole episode
    after it; `camera_steps_per_s` is computed from steady_s. The
    episode runs under torch.no_grad(); the distillation update takes
    its gradients with torch.func, which that does not switch off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prep = prepare_fleet_run(spec, device=device)
    dev = prep.device
    mspec = spec.metrics

    with torch.no_grad():
        t0 = time.perf_counter()
        with span("fleet/compile", provider=spec.provider,
                  metrics=mspec is not None):
            episode_step(prep.cfg, prep.wl, prep.statics, prep.state,
                         prep.provider, prep.provider.init_carry(prep.state),
                         0, metrics=mspec)
            _sync(dev)
        compile_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        with span("fleet/steady", provider=spec.provider,
                  n_cameras=spec.n_cameras):
            res = prep.episode()
            _sync(dev)
        steady_s = time.perf_counter() - t0

    state, out, ex, carry = res
    fleet_metrics = ex.get("metrics")
    distill_loss = learned = None
    if "learn" in ex:
        # fleet-mean loss over the cameras that updated each step; -1.0
        # marks off-cadence/idle steps
        loss = ex["learn"]["loss"].cpu().numpy().astype(np.float32)
        upd = loss >= 0.0
        nupd = upd.sum(axis=1)
        distill_loss = tuple(
            float(v) for v in np.where(
                nupd > 0, (loss * upd).sum(axis=1) / np.maximum(nupd, 1),
                -1.0))
        learned = (prep.provider, carry)

    acc = out.acc_chosen.cpu().numpy().astype(np.float32)      # [E, F]
    sent = out.sent.cpu().numpy()                               # [E, F, N]
    return FleetResult(
        spec=spec, n_cameras=spec.n_cameras,
        n_steps=int(acc.shape[0]),
        accuracy=float(acc.mean()),
        acc_per_step=tuple(float(a) for a in acc.mean(axis=1)),
        chosen=tuple(tuple(int(c) for c in row)
                     for row in out.chosen.cpu().numpy()),
        frames_sent=tuple(int(s) for s in sent.sum(axis=(1, 2))),
        mean_shape=float(out.n_explored.cpu().numpy()
                         .astype(np.float32).mean()),
        timings={"build_s": prep.build_s, "compile_s": compile_s,
                 "steady_s": steady_s,
                 "episode_s": compile_s + steady_s},
        distill_loss=distill_loss, state=state, out=out,
        metrics=fleet_metrics, learned=learned)
