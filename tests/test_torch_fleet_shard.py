"""The sharded fleet (`ShardSpec`, `mesh=` through fleet/api.py,
fleet/runner.py and serving/engine.py) against the port's unsharded run
and the JAX package's unsharded run at equal F, at smoke width
(`madeye-approx-smoke`), 4 cameras, 4 steps.

The reference cannot run sharded under the installed jax
(`tests/test_fleet_api.py::test_run_fleet_sharded_matches_unsharded`
fails), so it is held at equal F unsharded. The multi-rank runs are 2
and 4 spawned gloo ranks (tests/torch_dist.py): meshes 2 x 1, 4 x 1 and
2 x 2, the scene provider with per-camera AR(1) links, the detector
frozen (through mesh=) and distilling with metrics, and the tables
provider with a per-camera [E, F] link trace.

Tolerances, and why:

- decisions (`chosen`, `frames_sent`, `explored`, `order`, `zooms`,
  `sent`, `k_send`), integer state and metrics: exact;
- sharded against unsharded: floats within 1e-5, learned heads within
  1e-6, losses 1e-5 relative. A rank's detector forward runs on its
  own cameras' crops only, a smaller batch, which may round apart (the
  reference's own F=1 / F=2 gap is 5.2e-06 on its heads; at 2 cameras a
  rank the runs here are bit-equal, at 1 camera the heads differ by
  4.5e-08). The zoom geometry's spread `nb_spread` = sqrt(E[c^2] -
  |E[c]|^2) is ill-conditioned for tight clusters (a variance of ~0
  under float32 cancellation), so it is held as a variance, within
  1e-2, as the oracle tests hold it;
- against the reference: test_torch_learn.py's tolerances (pred_acc
  1e-5, per-step accuracy 1e-6, losses 1e-5 relative, 98% of the
  learned heads' elements within 2e-6 and all within 3 lr an update).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.core import DEFAULT_GRID as J_GRID  # noqa: E402
from repro.core.tradeoff import BudgetConfig as JBudget  # noqa: E402
from repro.fleet import runner as jrunner  # noqa: E402
from repro.fleet.api import FleetRunSpec as JSpec  # noqa: E402
from repro.fleet.api import ShardSpec as JShardSpec  # noqa: E402
from repro.fleet.api import run_fleet as j_run_fleet  # noqa: E402
from repro.fleet.runner import save_detector_params  # noqa: E402
from repro.fleet.state import fleet_config as j_fleet_config  # noqa: E402
from repro.fleet.state import fleet_statics as j_statics  # noqa: E402
from repro.fleet.state import workload_spec as j_wl_spec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.fleet.api import FleetRunSpec, ShardSpec  # noqa: E402
from repro_torch.fleet.api import run_fleet  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.learn.spec import DistillSpec  # noqa: E402
from repro_torch.models import detector as tdet  # noqa: E402
from torch_dist import _np, _result_np, fleet_suite_rank, spawn  # noqa: E402

F, E = 4, 4
MESHES = [(2, 1), (4, 1), (2, 2)]
BASE = dict(n_cameras=F, n_steps=E, budget={"fps": 3.0}, seed=3)
DECISIONS = ("explored", "order", "n_explored", "zooms", "sent", "k_send",
             "chosen")


def _weights(path):
    tree = tdet.detector_init(torch.Generator().manual_seed(1),
                              get_smoke_config("madeye-approx"))
    return save_detector_params(path, _np(tree))


def _specs(npz):
    det = {"det_params": npz, "thresh": 0.3}
    return {
        "scene": (JSpec(provider="scene", provider_kwargs={"net_seed": 7},
                        **BASE).to_json(), "shard"),
        "detector": (JSpec(provider="detector", shortlist_k=9,
                           provider_kwargs=det, **BASE).to_json(), "mesh"),
        "distill": (JSpec(provider="detector", shortlist_k=9, distill=True,
                          metrics=True, provider_kwargs=det,
                          **BASE).to_json(), "shard"),
    }


def _link():
    """A per-camera [E, F] link trace, cameras far apart (0.5-40 Mbps),
    so that a camera reading another's link decides otherwise."""
    return np.random.default_rng(11).uniform(0.5, 40.0, (E, F)).astype(
        np.float32)


@pytest.fixture(scope="module")
def det_npz(tmp_path_factory):
    return _weights(str(tmp_path_factory.mktemp("det") / "det.npz"))


# the spawns: 2 ranks (mesh 2 x 1, rank 0 also running everything
# unsharded, the shims, an uneven fleet), then 4 ranks (4 x 1 and 2 x 2)
SPAWNS = [(2, [(2, 1)], True), (4, [(4, 1), (2, 2)], False)]


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory, det_npz):
    """The ranks of SPAWNS, one spawn after another (at most four rank
    processes at a time beside the other test workers), from a thread
    started with the module's first test, so that they run while the
    reference's side is computed."""
    tmp = tmp_path_factory.mktemp("fleet")
    specs = _specs(det_npz)

    def run_all():
        return [spawn(fleet_suite_rank, n, tmp, specs, meshes, _link(),
                      det_npz if first else None).join()
                for n, meshes, first in SPAWNS]

    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_all)


@pytest.fixture(scope="module")
def results(ranks):
    """{mesh: [each rank's results on it]} and "whole": rank 0's
    unsharded runs, "first": the first spawn's ranks (shims, uneven)."""
    spawns = ranks.result()
    out = {"whole": spawns[0][0]["whole"], "first": spawns[0]}
    for (_, meshes, _), got in zip(SPAWNS, spawns):
        for m in meshes:
            out[m] = [r[m] for r in got]
    return out


@pytest.fixture(scope="module")
def reference(det_npz):
    """The JAX package's unsharded runs at equal F, and its tables
    episode with the per-camera link, one after another (compiled in
    threads they take half the time, but load the machine enough to
    upset the timing gates of the tests running beside them)."""
    return {"runs": {name: j_run_fleet(JSpec.from_json(js))
                     for name, (js, _) in _specs(det_npz).items()},
            "tables": _j_tables()[1]}


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def assert_tree_close(got, want, atol, rtol=0.0, path=""):
    """Integer and bool leaves exact, floats within (atol, rtol)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            if path.endswith("state") and k == "nb_spread":
                np.testing.assert_allclose(np.square(got[k]),
                                           np.square(want[k]), atol=1e-2,
                                           err_msg=f"{path}/{k}")
            else:
                assert_tree_close(got[k], want[k], atol, rtol, f"{path}/{k}")
        return
    if isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, atol, rtol, f"{path}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, path
    if want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                                   err_msg=path)


def assert_same_run(got, want, label):
    """A sharded run against the port's unsharded one."""
    assert got["chosen"] == want["chosen"], label
    assert got["frames_sent"] == want["frames_sent"], label
    assert_tree_close(got["out"], want["out"], 1e-5, path=f"{label}/out")
    assert_tree_close(got["state"], want["state"], 1e-5,
                      path=f"{label}/state")
    np.testing.assert_allclose(got["acc_per_step"], want["acc_per_step"],
                               atol=1e-5, err_msg=label)
    if want["metrics"] is not None:
        assert_tree_close(got["metrics"], want["metrics"], 1e-5, 1e-5,
                          path=f"{label}/metrics")
    if want["distill_loss"] is not None:
        np.testing.assert_allclose(got["distill_loss"],
                                   want["distill_loss"], rtol=1e-5,
                                   err_msg=label)
        assert_tree_close(got["heads"], want["heads"], 1e-6,
                          path=f"{label}/heads")


def assert_matches_reference(got, want, label):
    """A port run against the reference's run of the same spec JSON."""
    assert got["chosen"] == want.chosen, label
    assert got["frames_sent"] == want.frames_sent, label
    for k in DECISIONS:
        np.testing.assert_array_equal(got["out"][k],
                                      np.asarray(getattr(want.out, k)),
                                      err_msg=f"{label}/{k}")
    np.testing.assert_allclose(got["out"]["pred_acc"],
                               np.asarray(want.out.pred_acc), atol=1e-5,
                               err_msg=label)
    np.testing.assert_allclose(got["acc_per_step"], want.acc_per_step,
                               atol=1e-6, err_msg=label)
    if want.metrics is not None:
        for k, v in want.metrics.items():
            a = np.asarray(v)
            if a.dtype.kind in "iub":
                np.testing.assert_array_equal(got["metrics"][k], a,
                                              err_msg=f"{label}/{k}")
            else:
                np.testing.assert_allclose(got["metrics"][k], a, atol=1e-5,
                                           rtol=1e-5, err_msg=f"{label}/{k}")
    if want.distill_loss is not None:
        np.testing.assert_allclose(got["distill_loss"], want.distill_loss,
                                   rtol=1e-5, err_msg=label)
        lr = DistillSpec().lr
        errs = np.concatenate([
            np.abs(np.asarray(got["heads"][m][p]) - np.asarray(
                want.learned_params(None)["heads"][m][p])).reshape(-1)
            for m in got["heads"] for p in got["heads"][m]])
        assert (errs <= 2e-6).mean() >= 0.98, label
        assert errs.max() <= 3 * lr * E, label


# ---------------------------------------------------------------------------
# ShardSpec and the spec JSON (this process)
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank():
    """Tears down the one-rank gloo group a debug mesh makes."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_shard_spec_resolution(one_rank):
    """As the reference's test_shard_spec_resolution; "production" needs
    256 ranks and raises in a world of one."""
    assert ShardSpec().build_mesh() is None
    with pytest.raises(ValueError):
        ShardSpec(kind="warp").build_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 256 devices"):
        ShardSpec(kind="production").build_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="need 512 devices"):
        ShardSpec(kind="production", multi_pod=True).build_mesh(
            device="cpu")
    mesh = ShardSpec(kind="debug").build_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")


@pytest.mark.parametrize("shard", [
    {"kind": "debug", "n_data": 2},
    {"kind": "production", "multi_pod": True},
    {"kind": "none"},
])
def test_spec_json_with_shard_matches_reference(shard):
    js = JSpec(provider="detector", shard=JShardSpec(**shard),
               shortlist_k=9, **BASE).to_json()
    ts = FleetRunSpec(provider="detector", shard=shard, shortlist_k=9,
                      **BASE)
    assert ts.to_json() == js
    assert isinstance(ts.shard, ShardSpec)
    assert FleetRunSpec.from_json(js) == ts
    assert FleetRunSpec.from_json(js).shard == ShardSpec(**shard)


@pytest.mark.parametrize("provider", ["scene", "detector"])
def test_one_rank_shard_is_the_unsharded_run(provider, det_npz, one_rank):
    """ShardSpec("debug") on a world of one (a 1 x 1 mesh), an explicit
    one-rank mesh, kind "none" and shard=None all run the unsharded
    episode bit for bit."""
    kw = dict(provider=provider, n_cameras=2, n_steps=3,
              budget={"fps": 3.0}, seed=3)
    if provider == "detector":
        kw.update(shortlist_k=9, provider_kwargs={"det_params": det_npz,
                                                  "thresh": 0.3})
    want = _result_np(run_fleet(FleetRunSpec(**kw), device="cpu"))
    for shard in ({"kind": "none"}, {"kind": "debug"}):
        got = _result_np(run_fleet(FleetRunSpec(shard=shard, **kw),
                                   device="cpu"))
        assert_tree_close({k: got[k] for k in ("out", "state")},
                          {k: want[k] for k in ("out", "state")}, 0.0)
    got = _result_np(run_fleet(FleetRunSpec(**kw),
                               mesh=make_debug_mesh(device="cpu"),
                               device="cpu"))
    assert_tree_close(got["out"], want["out"], 0.0)


# ---------------------------------------------------------------------------
# 2 and 4 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["scene", "detector", "distill"])
def test_sharded_run_matches_reference(reference, results, name):
    """The sharded runs of every mesh and the unsharded port run against
    the reference's unsharded run at equal F. (The reference fixture
    comes first: the parent computes it while the ranks run.)"""
    want = reference["runs"][name]
    assert_matches_reference(results["whole"]["runs"][name], want,
                             f"{name} unsharded")
    for mesh in MESHES:
        for rank, r in enumerate(results[mesh]):
            assert_matches_reference(r["runs"][name], want,
                                     f"{name}@{mesh} rank {rank}")


@pytest.mark.parametrize("mesh", MESHES, ids=["2x1", "4x1", "2x2"])
@pytest.mark.parametrize("name", ["scene", "detector", "distill"])
def test_sharded_run_matches_unsharded(results, name, mesh):
    """Every rank returns the whole fleet's result, equal to the port's
    unsharded run (made on rank 0 of the first spawn, on one thread as
    the ranks)."""
    whole = results["whole"]["runs"][name]
    for rank, r in enumerate(results[mesh]):
        assert_same_run(r["runs"][name], whole,
                        f"{name}@{mesh} rank {rank}")


def _j_tables():
    """The reference's tables episode with the per-camera link."""
    budget = JBudget(fps=3.0)
    cfg = j_fleet_config(J_GRID, budget)
    wl = JSpec().workload_obj()
    ep, state = jrunner.make_tables_provider(J_GRID, wl, cfg, n_cameras=F,
                                             n_steps=E)
    link = jnp.asarray(_link())
    ep = ep._replace(mbps=link, rtt=jnp.broadcast_to(ep.rtt[:, None],
                                                     link.shape))
    return jrunner.run_fleet_episode(cfg, j_wl_spec(wl), j_statics(J_GRID),
                                     state, ep)


def test_tables_per_camera_link(reference, results):
    """The tables provider cuts a per-camera [E, F] link to the rank's
    cameras: sharded equals unsharded and the reference."""
    jout = reference["tables"]
    whole = results["whole"]["tables"]
    for mesh in MESHES:
        for rank, r in enumerate(results[mesh]):
            t = r["tables"]
            assert_tree_close(t, whole, 1e-5,
                              path=f"tables@{mesh} rank {rank}")
            for k in DECISIONS:
                np.testing.assert_array_equal(t["out"][k],
                                              np.asarray(getattr(jout, k)),
                                              err_msg=k)
            np.testing.assert_allclose(t["out"]["pred_acc"],
                                       np.asarray(jout.pred_acc), atol=1e-5)
    # the link differs between cameras, and so do their budgets
    assert len({tuple(c) for c in whole["out"]["k_send"].T}) > 1


@pytest.mark.parametrize("shim", ["tables", "scene", "detector"])
def test_controller_shims_take_a_mesh(results, shim):
    """run_fleet_*_controller(mesh=...) on 2 ranks return the unsharded
    shims' outputs."""
    for rank, r in enumerate(results["first"]):
        whole, sharded = r["engine"][shim]
        assert_tree_close(sharded, whole, 1e-5, path=f"{shim} rank {rank}")


def test_uneven_fleet_raises(results):
    for r in results["first"]:
        assert r["uneven"] == ("3 cameras do not split evenly over the "
                               "mesh's 2 data ranks")
