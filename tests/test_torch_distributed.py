"""The port's sharding (`repro_torch.distributed`, `launch/mesh.py`,
`train/elastic.py`, `crosspod_allreduce_compressed`, checkpoints of
DTensors) against the JAX package.

- Rules: `param_shardings` / `opt_shardings` give the reference's
  PartitionSpec for every leaf of every assigned config at full size
  (shapes from the reference's `jax.eval_shape`) on abstract (16, 16)
  and (2, 16, 16) meshes under all three rule sets; `batch_shardings` /
  `kvcache_shardings` on the shapes `launch/steps.py` passes; the port's
  SMOKE trees give the reference's path strings. Exact.
- Multi-rank (4 spawned gloo ranks, tests/torch_dist.py):
  `ring_reduce_attend` on a sequence-sharded cache against full
  attention and the reference's (float32 within 1e-6: the same float32
  products, summed in another order; bf16 outputs within one bf16 ulp
  of their magnitude: one rounding of a float32 value that may sit on
  either side of a tie), `psum_scatter_grads` against the sum (1e-6
  relative: gloo adds in another order) and `ring_allgather` (exact),
  4 pipeline stages against the layers in sequence (bit-equal) and the
  reference's pipeline (1e-6: XLA's and PyTorch's tanh and products
  round apart), elastic save / shrink / restore / reshard / step
  (exact), and compression on a (2, 2) ("pod", "data") mesh to the
  reference end to end's bounds and within 1e-6 of the reference's
  compress / decompress mean per pod.
"""
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro.configs import ASSIGNED_ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs import shapes_for as j_shapes_for  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch.mesh import make_abstract_mesh as j_abstract  # noqa: E402
from repro.models import kvcache as jkvc  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import trainer as jtrainer  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    psum_scatter_grads,
    ring_allgather,
    ring_reduce_attend,
)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from torch_dist import distributed_rank, spawn  # noqa: E402

KEY = jax.ShapeDtypeStruct((2,), jnp.uint32)
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
RULE_ENV = {"train": {}, "serve_tp": {"REPRO_SERVE_TP_ONLY": "1"},
            "replicated": {"REPRO_SERVE_REPLICATED": "1"}}
N_COMP_STEPS = 30


def j_specs(tree):
    """[(path, PartitionSpec entries)] of a reference sharding tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))
    return sorted((jshd._path_str(kp), tuple(s.spec)) for kp, s in flat)


def t_specs(tree):
    out = []
    shd.tree_map_with_path(
        lambda kp, s: out.append((shd._path_str(kp), tuple(s.spec))), tree)
    return sorted(out)


def j_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return sorted(jshd._path_str(kp) for kp, _ in flat)


def t_paths(tree):
    out = []
    shd.tree_map_with_path(lambda kp, _: out.append(shd._path_str(kp)),
                           tree)
    return sorted(out)


def set_rules(monkeypatch, rules):
    for k in ("REPRO_SERVE_TP_ONLY", "REPRO_SERVE_REPLICATED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in RULE_ENV[rules].items():
        monkeypatch.setenv(k, v)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

def test_assigned_archs_match():
    assert list(ASSIGNED_ARCHS) == list(J_ARCHS)


@pytest.mark.parametrize("arch", J_ARCHS)
def test_param_and_opt_rules_match_reference(arch, monkeypatch):
    """Every leaf of the full config's parameters, AdamW and Adafactor
    states, on both production meshes under each rule set."""
    cfg = j_config(arch)
    p_shape = jax.eval_shape(jtrainer.make_train_step(cfg).init_params, KEY)
    opts = [jax.eval_shape(jtrainer.make_train_step(
        cfg, optimizer=o).init_opt, p_shape) for o in ("adamw", "adafactor")]
    for shape, axes in MESHES:
        jm, tm = j_abstract(shape, axes), tmesh.make_abstract_mesh(shape,
                                                                    axes)
        for rules in RULE_ENV:
            set_rules(monkeypatch, rules)
            assert t_specs(shd.param_shardings(p_shape, tm, rules=rules)) \
                == j_specs(jshd.param_shardings(p_shape, jm)), (shape, rules)
            for o in opts:
                assert t_specs(shd.opt_shardings(o, tm, rules=rules)) == \
                    j_specs(jshd.opt_shardings(o, jm)), (shape, rules)


@pytest.mark.parametrize("arch", J_ARCHS)
def test_batch_and_cache_rules_match_reference(arch):
    """batch_shardings / kvcache_shardings on the inputs launch/steps.py
    builds for each of the config's shapes."""
    cfg = j_config(arch)
    for shape, axes in MESHES:
        jm, tm = j_abstract(shape, axes), tmesh.make_abstract_mesh(shape,
                                                                    axes)
        for sh in j_shapes_for(cfg):
            trees = []
            if sh.kind == "train":
                for mbs in (1, 4):
                    batch = jtrainer.make_train_step(
                        cfg, microbatches=mbs).batch_spec(sh)
                    trees.append(("batch", batch, {"microbatched": mbs > 1}))
            elif sh.kind in ("decode", "prefill"):
                b = sh.global_batch
                trees.append(("batch", {"t": jax.ShapeDtypeStruct(
                    (b, 1 if sh.kind == "decode" else sh.seq_len),
                    jnp.int32)}, {}))
                if sh.kind == "decode":
                    cache = jkvc.cache_specs(cfg, b, sh.seq_len)
                    for sp in (False, True):
                        trees.append(("cache", cache,
                                      {"sequence_parallel": sp}))
            else:
                trees.append(("batch", {"x": jax.ShapeDtypeStruct(
                    (sh.global_batch, sh.img_res or 224, sh.img_res or 224,
                     3), jnp.float32)}, {}))
            for kind, tree, kw in trees:
                jf = (jshd.batch_shardings if kind == "batch"
                      else jshd.kvcache_shardings)
                tf = (shd.batch_shardings if kind == "batch"
                      else shd.kvcache_shardings)
                assert t_specs(tf(tree, tm, **kw)) == \
                    j_specs(jf(tree, jm, **kw)), (sh.name, kind, kw)


@pytest.mark.parametrize("arch", J_ARCHS + ["madeye-approx"])
def test_smoke_trees_give_reference_paths(arch):
    """The port's own SMOKE parameter and optimizer trees walk to the
    reference's path strings, so the rule regexes read the same paths;
    their specs on a (2, 2) mesh agree too."""
    tcfg, jcfg = get_smoke_config(arch), j_smoke(arch)
    ts = trainer.make_train_step(tcfg)
    params = ts.init_params(np.random.default_rng(0), "cpu")
    jts = jtrainer.make_train_step(jcfg)
    j_params = jax.eval_shape(jts.init_params, KEY)
    assert t_paths(params) == j_paths(j_params)
    assert t_paths(ts.init_opt(params)) == j_paths(
        jax.eval_shape(jts.init_opt, j_params))
    tm = tmesh.make_abstract_mesh((2, 2), ("data", "model"))
    jm = j_abstract((2, 2), ("data", "model"))
    assert t_specs(shd.param_shardings(params, tm)) == \
        j_specs(jshd.param_shardings(j_params, jm))


def test_rules_respect_divisibility_and_placements():
    mesh = tmesh.make_abstract_mesh((16, 16), ("data", "model"))
    odd = {"attn": {"wq": {"w": torch.empty(7, 13, device="meta")}}}
    assert shd.param_shardings(odd, mesh)["attn"]["wq"]["w"].spec == \
        (None, None)
    big = {"attn": {"wq": {"w": torch.empty(4096, 4096, device="meta")}}}
    s = shd.param_shardings(big, mesh)["attn"]["wq"]["w"]
    assert s.spec == ("data", "model")
    assert s.placements() == (Shard(0), Shard(1))
    pod = tmesh.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    s = shd.param_shardings(big, pod)["attn"]["wq"]["w"]
    assert s.spec == (("pod", "data"), "model")
    assert s.placements() == (Shard(0), Shard(0), Shard(1))
    assert shd.replicated({"a": torch.empty(3)}, pod)["a"].placements() \
        == (Replicate(),) * 3
    assert shd.dp_axes(pod) == ("pod", "data")
    assert shd.axis_size(pod, ("pod", "data")) == 32
    with pytest.raises(ValueError, match="rule set"):
        shd.param_shardings(big, mesh, rules="serve")


# ---------------------------------------------------------------------------
# meshes in this process
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank():
    """A one-rank gloo group made by make_debug_mesh, torn down after."""
    assert not dist.is_initialized()
    yield tmesh.make_debug_mesh(device="cpu")
    dist.destroy_process_group()


def test_abstract_and_production_meshes():
    m = tmesh.make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert m.shape == {"pod": 2, "data": 16, "model": 16}
    assert m.size == 512 and m.axis_names == ("pod", "data", "model")
    for multi, n, shape in ((False, 256, (16, 16)),
                            (True, 512, (2, 16, 16))):
        with pytest.raises(RuntimeError, match=re.escape(
                f"need {n} devices for mesh {shape}, have 1")):
            tmesh.make_production_mesh(multi, device="cpu")
    with pytest.raises(RuntimeError, match="need 2 devices"):
        tmesh.make_debug_mesh(2, 1, device="cpu")
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_debug_mesh()


def test_one_rank_mesh_and_collectives(one_rank):
    mesh = one_rank
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
    assert dist.get_backend() == "gloo"
    assert tmesh.mesh_shape(mesh) == {"data": 1, "model": 1}
    rng = np.random.default_rng(3)
    g = {"a": torch.as_tensor(rng.standard_normal((4, 3), np.float32))}
    assert torch.equal(psum_scatter_grads(g, (mesh, "data"))["a"], g["a"])
    x = torch.arange(6.0).reshape(2, 3)
    assert torch.equal(ring_allgather(x, (mesh, "model")), x[None])
    q, k, v = (torch.as_tensor(rng.standard_normal(s, np.float32))
               for s in ((2, 1, 4, 8), (2, 16, 4, 8), (2, 16, 4, 8)))
    got = ring_reduce_attend(q, k, v, (mesh, "model"), scale=0.3)
    w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.3, -1)
    want = torch.einsum("bhqk,bkhd->bqhd", w, v)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_checkpoint_of_dtensors_one_rank(one_rank, tmp_path):
    """A tree of DTensors saves byte for byte as the plain tree does."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.train.elastic import reshard

    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
    tree = {"w": torch.arange(12.0).reshape(4, 3),
            "b": torch.arange(3).to(torch.bfloat16)}
    dt = reshard(tree, shd.param_shardings(tree, mesh))
    a = ckpt.save(str(tmp_path / "a"), 1, dt)
    b = ckpt.save(str(tmp_path / "b"), 1, tree)
    for name in ("manifest.json", "shard_00000.msgpack"):
        assert (tmp_path / "a" / os.path.basename(a) / name).read_bytes() \
            == (tmp_path / "b" / os.path.basename(b) / name).read_bytes()


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

def _attend_inputs():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    v = rng.standard_normal((2, 32, 4, 16)).astype(np.float32)
    grads = {"div": rng.standard_normal((4, 8, 3)).astype(np.float32),
             "odd": rng.standard_normal((4, 6)).astype(np.float32)}
    return q, k, v, grads, 1.0 / math.sqrt(16)


def _pipe_inputs():
    rng = np.random.default_rng(1)
    n_layers, d, m, mb = 8, 4, 5, 2
    params = {"w": (rng.standard_normal((n_layers, d, d)) * 0.3)
              .astype(np.float32),
              "b": (rng.standard_normal((n_layers, d)) * 0.1)
              .astype(np.float32)}
    return params, rng.standard_normal((m, mb, d)).astype(np.float32), 4


def _comp_inputs():
    return (np.random.default_rng(2).standard_normal((4, 64))
            .astype(np.float32), N_COMP_STEPS)


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """The four ranks, started with the module's first test so that they
    run while the reference's side is computed."""
    tmp = tmp_path_factory.mktemp("dist")
    run = spawn(distributed_rank, 4, tmp, str(tmp), _attend_inputs(),
                _pipe_inputs(), _comp_inputs())
    yield {"run": run, "ckpt": os.path.join(str(tmp), "ckpt")}
    run.join()


@pytest.fixture(scope="module")
def results(ranks):
    return ranks["run"].join()


def _j_attend(q, k, v, scale):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    from repro.distributed.collectives import ring_reduce_attend as j_rra
    from repro.launch.mesh import make_debug_mesh

    fn = shard_map(lambda q, k, v: j_rra(q, k, v, "model", scale=scale),
                   mesh=make_debug_mesh(1, 1),
                   in_specs=(P(), P(None, "model"), P(None, "model")),
                   out_specs=P())
    return np.asarray(fn(q, k, v).astype(jnp.float32))


def test_ring_reduce_attend_four_ranks(results):
    q, k, v, _, scale = _attend_inputs()
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    w = np.exp(s - s.max(-1, keepdims=True))
    full = np.einsum("bhqk,bkhd->bqhd", w / w.sum(-1, keepdims=True), v)
    j32 = _j_attend(q, k, v, scale)
    jbf = _j_attend(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                    scale)
    ulp = 2.0 ** (math.floor(math.log2(np.abs(jbf).max())) - 7)
    for r in results:
        got = r["collectives"]
        np.testing.assert_allclose(got["attend_f32"], full, atol=1e-6)
        np.testing.assert_allclose(got["attend_f32"], j32, atol=1e-6)
        np.testing.assert_allclose(got["attend_bf16"], jbf, atol=ulp)


def test_psum_scatter_and_ring_allgather_four_ranks(results):
    grads = _attend_inputs()[3]
    total = {k: g.sum(0) for k, g in grads.items()}
    for rank, r in enumerate(results):
        got = r["collectives"]
        np.testing.assert_allclose(got["scatter"]["div"],
                                   total["div"][2 * rank:2 * rank + 2],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got["scatter"]["odd"], total["odd"],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(
            got["allgather"], np.repeat(np.arange(4.0), 3).reshape(4, 3))


def test_pipeline_four_stages(results):
    from repro.distributed.pipeline import make_pipelined_forward as j_pipe
    from repro.distributed.pipeline import split_stages as j_split
    from repro.launch.mesh import make_debug_mesh

    params, x, _ = _pipe_inputs()

    def body(lp, h, extra):
        return jnp.tanh(h @ lp["w"] + lp["b"])

    jp = {k: jnp.asarray(a) for k, a in params.items()}
    want = np.asarray(j_pipe(body, make_debug_mesh(1, 1), 1)(
        j_split(jp, 1), jnp.asarray(x), None))
    for piped, seq in (r["pipeline"] for r in results):
        np.testing.assert_array_equal(piped, seq)
        np.testing.assert_allclose(piped, want, atol=1e-6)


def test_elastic_save_shrink_restore_four_ranks(results, ranks):
    whole = np.arange(32, dtype=np.float32).reshape(8, 4)
    for rank, r in enumerate((x["elastic"] for x in results)):
        assert r["local4"] == (2, 4) and r["same"]
        assert r["mesh2"] == [0, 1] and r["n_processes"] == 4
        assert r["batch"] == 128
        assert r["replicated"][0]
        np.testing.assert_array_equal(r["replicated"][1], whole)
        if rank < 2:
            assert r["coord2"] == (rank,) and r["local2"] == (4, 4)
            np.testing.assert_array_equal(r["moved_local2"],
                                          whole[4 * rank:4 * rank + 4])
            np.testing.assert_array_equal(r["w2"], whole)
            kind, shape, stepped = r["step"]
            assert kind == "DTensor" and shape == (8, 4)
            np.testing.assert_allclose(stepped, whole * 0.9, rtol=1e-6)
        else:
            assert r["coord2"] is None and r["moved_local2"].size == 0
    # one checkpoint, published; the reference restores it
    assert sorted(os.listdir(ranks["ckpt"])) == ["step_00000010"]
    back, manifest = jckpt.restore(ranks["ckpt"], 10,
                                   {"w": jnp.zeros((8, 4))})
    np.testing.assert_array_equal(np.asarray(back["w"]), whole)
    assert manifest["n_processes"] == 4


def test_crosspod_compression_four_ranks(results):
    g, n = _comp_inputs()
    exact = g.reshape(2, 2, 64).mean(0)                      # [data, 64]
    want = {}
    for d in range(2):
        errs = [jcomp.init_ef({"w": jnp.zeros(64)}) for _ in range(2)]
        means = []
        for _ in range(n):
            deq = []
            for p in range(2):
                qs, sc, errs[p] = jcomp.compress(
                    {"w": jnp.asarray(g[2 * p + d])}, errs[p])
                deq.append(np.asarray(jcomp.decompress(qs, sc)["w"]))
            means.append((deq[0] + deq[1]) / 2)
        want[d] = np.stack(means)
    for rank, r in enumerate(x["compression"] for x in results):
        d = rank % 2
        np.testing.assert_allclose(r.mean(0), exact[d], atol=2e-2)
        np.testing.assert_allclose(r[-1], exact[d], atol=0.1)
        np.testing.assert_allclose(r, want[d], atol=1e-6)


def test_rules_read_no_environment(monkeypatch):
    """The rule set is an argument: the reference's environment switches
    change nothing here."""
    mesh = tmesh.make_abstract_mesh((16, 16), ("data", "model"))
    big = {"mlp": {"up": {"w": torch.empty(4096, 4096, device="meta")}}}
    monkeypatch.setenv("REPRO_SERVE_REPLICATED", "1")
    assert shd.param_shardings(big, mesh)["mlp"]["up"]["w"].spec == \
        ("data", "model")
    assert shd.param_shardings(big, mesh, rules="replicated")["mlp"]["up"][
        "w"].spec == ()
