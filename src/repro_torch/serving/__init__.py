"""Host-side serving substrate (numpy): teacher oracles, network traces,
ground-truth accuracy tables, the PTZ camera and the single-camera
pipeline with its baselines — copies of the reference package's, bit-equal
on the same seeds (tests/test_torch_tables.py)."""
from repro_torch.serving.accuracy import (
    detection_tables,
    evaluate_selection,
    query_acc_table,
    workload_acc_table,
)
from repro_torch.serving.pipeline import (
    ZOOM_LEVELS,
    RunResult,
    run_madeye,
    run_scheme,
)
from repro_torch.serving.teachers import TEACHERS
from repro_torch.serving.transport import NetworkTrace
