"""Fleet-scale MadEye control loop: state, shape search, controller step,
observation providers and the `run_fleet` entry point."""
from repro_torch.fleet.api import (
    DEFAULT_QUERIES,
    FleetResult,
    FleetRunSpec,
    ShardSpec,
    available_providers,
    prepare_fleet_run,
    register_provider,
    run_fleet,
)
from repro_torch.fleet.runner import (
    EpisodeTables,
    build_episode_tables,
    make_detector_provider,
    make_scene_provider,
    make_tables_provider,
    materialize_scene_tables,
    run_fleet_episode,
    shard_fleet,
)
from repro_torch.fleet.state import (
    FleetConfig,
    FleetState,
    fleet_config,
    fleet_statics,
    init_fleet,
    workload_spec,
)
from repro_torch.fleet.step import FleetObs, FleetStepOut, fleet_step
