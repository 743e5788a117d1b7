"""Fleet-scale MadEye control loop: state, shape search, controller step,
observation providers and the `run_fleet` entry point."""
from repro_torch.fleet.api import (
    DEFAULT_QUERIES,
    FleetResult,
    FleetRunSpec,
    prepare_fleet_run,
    run_fleet,
)
from repro_torch.fleet.state import FleetConfig, FleetState, init_fleet
from repro_torch.fleet.step import FleetObs, FleetStepOut, fleet_step
