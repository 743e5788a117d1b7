"""The plain reference against the port's CPU path at smoke size: every
stage's number reads 0 (on CPU tensors the port runs the plain versions
of its kernels, which the reference copies), in the frozen and the
distilling configuration, and the traced run reads its per-layer
metrics."""
from __future__ import annotations

import pytest

from conftest import run_smoke


@pytest.mark.parametrize("workload", ["smoke-approx", "smoke-distill"])
def test_reference_matches_port_on_cpu(smoke_root, workload):
    res, lines = run_smoke(smoke_root, workload, seconds=1.0)
    assert res["correct"], lines
    for name, c in res["checks"].items():
        assert c["value"] == 0, (name, c)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"camera_steps_per_s", "step_ms_p95",
                                   "peak_mem_gib", "setup_s"}
    assert list(res)[-1] == "checks"
    if workload == "smoke-distill":
        assert {"learn_loss", "learn_update"} <= set(res["checks"])


def test_traced_run_on_cpu(smoke_root):
    res, lines = run_smoke(smoke_root, "smoke-approx", seconds=0.5,
                           trace=True)
    assert res["correct"], lines
    # no device here: the device readers find nothing and stay silent
    assert set(res["metrics"]) == {"torch_ops_per_step"}
    assert res["metrics"]["torch_ops_per_step"]["value"] > 1000
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
