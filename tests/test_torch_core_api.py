"""The port's small host-side APIs against the reference on the same
inputs: `core/ewma.init_state` (and an EWMA run from it),
`core/search.shape_stats`, `core/rank.detections_to_counts`,
`core/baselines.evaluate_choices`, and the `ObservationProvider`
protocol every registered provider meets. EWMA floats within 1e-6
(float32 products in another order); the rest exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core import ewma as jewma  # noqa: E402
from repro.core import rank as jrank  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.core.grid import OrientationGrid as JGrid  # noqa: E402
from repro_torch.core import DEFAULT_GRID, OrientationGrid  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import ewma as tewma  # noqa: E402
from repro_torch.core import rank as trank  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.fleet.api import (  # noqa: E402
    FleetRunSpec,
    ObservationProvider,
    available_providers,
    prepare_fleet_run,
)


def test_ewma_init_state_and_updates_match_reference():
    n = DEFAULT_GRID.n_cells
    js = jewma.init_state(n)
    ts = tewma.init_state(n, device="cpu")
    for a, b in zip(js, ts):
        assert b.shape == (n,) and b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    rng = np.random.default_rng(0)
    for _ in range(6):
        visited = rng.random(n) < 0.4
        vals = rng.random(n).astype(np.float32)
        js = jewma.update(js, jnp.asarray(visited), jnp.asarray(vals))
        ts = tewma.update(ts, torch.as_tensor(visited),
                          torch.as_tensor(vals))
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
    np.testing.assert_allclose(tewma.labels(ts).numpy(),
                               np.asarray(jewma.labels(js)), atol=1e-6)


@pytest.mark.parametrize("pan_step", [30.0, 15.0])
def test_shape_stats_matches_reference(pan_step):
    tg, jg = OrientationGrid(pan_step=pan_step), JGrid(pan_step=pan_step)
    rng = np.random.default_rng(int(pan_step))
    masks = [np.zeros(tg.n_cells, bool)] + [
        rng.random(tg.n_cells) < p for p in (0.05, 0.2, 0.6, 1.0)]
    for m in masks:
        assert tsearch.shape_stats(m, tg) == jsearch.shape_stats(m, jg)


def test_detections_to_counts_matches_reference():
    rng = np.random.default_rng(1)
    boxes = rng.random((32, 4)).astype(np.float32)
    scores = rng.random(32).astype(np.float32)
    classes = rng.integers(0, 2, 32)
    scores[3] = 0.5                              # at the threshold
    for cls in (0, 1):
        for thresh in (0.5, 0.8, 1.1):
            assert (trank.detections_to_counts(boxes, scores, classes, cls,
                                               score_thresh=thresh)
                    == jrank.detections_to_counts(boxes, scores, classes,
                                                  cls, score_thresh=thresh))


def test_evaluate_choices_matches_reference():
    rng = np.random.default_rng(2)
    acc = rng.random((40, 75))
    one = rng.integers(0, 75, 40)
    several = rng.integers(0, 75, (40, 3))
    assert tbase.evaluate_choices(acc, one) == jbase.evaluate_choices(acc,
                                                                      one)
    assert (tbase.evaluate_choices(acc, several)
            == jbase.evaluate_choices(acc, several))
    assert tbase.evaluate_choices(acc, tbase.best_dynamic(acc)) == \
        pytest.approx(acc.max(1).mean())


@pytest.mark.parametrize("provider", ["tables", "scene", "detector"])
def test_registered_providers_meet_the_protocol(provider):
    assert provider in available_providers()
    prep = prepare_fleet_run(FleetRunSpec(provider=provider, n_cameras=1,
                                          n_steps=2), device="cpu")
    assert isinstance(prep.provider, ObservationProvider)
    assert prep.provider.n_steps >= 2
    assert not isinstance(object(), ObservationProvider)
