"""The port's launchers (`repro_torch.launch.steps`, `.dryrun`,
`.analysis`, `models/kvcache.cache_specs`,
`distributed/sharding.collective_bytes`) against the JAX package.

- build_cell: for every assigned arch at each of its four shapes on an
  abstract (16, 16) mesh, and for one arch of each family on
  (2, 16, 16), the args' paths, shapes and dtypes and the in / out
  sharding specs equal the reference's build_cell on its abstract mesh
  (the key: the port's two uint32 words in int64 for the reference's
  uint32). Exact.
- cache_specs equal the reference's.
- In a spawned process on a "fake" world of 4 ranks (tests/torch_dist.py,
  started by a module fixture while the reference's cells build):
  collective_bytes of four redistributions of known DTensors equal the
  reference's HLO parser on lines of the same output types (an
  all-to-all counted once, though the CPU group lowers it to an
  all-gather); dryrun.run_cell on SMOKE configs of each family (dense
  LM train and decode, MoE/MLA LM, ViT, Swin, DiT, MMDiT) on a (2, 2)
  mesh gives the reference's result keys; on a 1 x 1 mesh the dry run's
  FLOPs equal FlopCounterMode's count of the real run (numpy weights).
- In a second: analysis's extrapolated flops, bytes and collective bytes
  equal a direct fake run at full depth (dense LM decode, ViT serve, DiT
  train, MMDiT sampler), exactly.
- In a one-rank gloo group: build_cell's fn on the cell's args laid out
  on a 1 x 1 mesh (DTensors) gives the plain tensors' outputs exactly
  (ViT serve, Swin serve at batch 1, the DiT sampler).
- On a (2, 2) mesh of 4 gloo ranks, SMOKE configs in float32 at the
  shapes cut to SMOKE size (tests/torch_dist.py `_small_shapes`):
  build_cell's fn on DTensors against the plain tensors' run for the
  split-S decode (batch 4 and 1), the per-shard GQA and MLA decode,
  the MoE prefill, an MoE-GQA decode, and the MoE and Swin train steps
  (check_step's float32 tolerances); every other output within 1e-5 of
  its largest magnitude (sums in another order across the shards); and
  moe_ffn alone at a capacity that drops assignments: output, aux loss
  and dropped fraction the plain layer's.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ASSIGNED_ARCHS as J_ARCHS  # noqa: E402
from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import shapes_for as j_shapes_for  # noqa: E402
from repro.distributed import sharding as jshd  # noqa: E402
from repro.launch.mesh import make_abstract_mesh as j_abstract  # noqa: E402
from repro.launch.steps import build_cell as j_build_cell  # noqa: E402
from repro.models import kvcache as jkvc  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch.mesh import make_abstract_mesh  # noqa: E402
from repro_torch.launch.steps import KEY_SDS, build_cell  # noqa: E402
from repro_torch.models import kvcache as kvc  # noqa: E402
from torch_dist import (  # noqa: E402
    analysis_rank,
    launch_rank,
    mesh_values_rank,
    one_rank_values_rank,
    spawn,
    spawn_alone,
)
from torch_train_inputs import check_step  # noqa: E402

SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))
# one arch of each family on the multi-pod mesh
MULTI_ARCHS = ["kimi-k2-1t-a32b", "vit-b16", "flux-dev"]
DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.int32: "int32", torch.bool: "bool"}
RESULT_KEYS = {"arch", "shape", "mesh", "chips", "lower_s", "compile_s",
               "flops", "bytes_accessed", "collective_bytes",
               "collective_total", "temp_size_in_bytes",
               "argument_size_in_bytes", "output_size_in_bytes",
               "bytes_per_device"}
# SMOKE cells dry-run on the (2, 2) mesh: every family
CELLS = [("stablelm-3b", "train_4k"), ("stablelm-3b", "decode_32k"),
         ("deepseek-v3-671b", "decode_32k"), ("vit-b16", "serve_b128"),
         ("swin-b", "serve_b1"), ("dit-l2", "gen_fast"),
         ("flux-dev", "gen_fast")]
# real run vs dry run on a 1 x 1 mesh (test_torch_launch_cuda.py's cells)
PARITY = [("vit-b16", "serve_b128"), ("dit-l2", "gen_fast")]
# DTensor args on a one-rank mesh vs plain tensors: the outputs equal
VALUES = [("vit-b16", "serve_b128"), ("swin-b", "serve_b1"),
          ("dit-l2", "gen_fast")]
# DTensor args on a (2, 2) mesh vs plain tensors: (arch, shape,
# sp_threshold); a decode cell also at a position in the first `model`
# rank's half of its cache
SP_OFF = 262144
MESH_CASES = [("stablelm-3b", "decode_32k", 32),         # split-S
              ("stablelm-3b", "decode_32k", SP_OFF),     # heads over model
              ("stablelm-3b", "long_500k", 64),          # split-S, batch 1
              ("deepseek-v3-671b", "decode_32k", SP_OFF),
              ("deepseek-v3-671b", "prefill_32k", SP_OFF),
              ("kimi-k2-1t-a32b", "decode_32k", 32),
              ("deepseek-v3-671b", "train_4k", SP_OFF),
              ("swin-b", "cls_224", SP_OFF)]
MESH_TRAIN = {"train_4k", "cls_224"}
MESH_REL = 1e-5
# moe_ffn alone: (arch, batch, seq, capacity_factor)
MOE_CASE = ("deepseek-v3-671b", 4, 16, 1.0)
# analysis vs a direct run: (arch, shape, SMOKE overrides); the MMDiT's
# double:single blocks at flux-dev's 1:2
ANALYSIS = [("stablelm-3b", "decode_32k", {}),
            ("vit-b16", "serve_b128", {}),
            ("dit-l2", "train_256", {}),
            ("flux-dev", "gen_fast", {"n_double_blocks": 1,
                                      "n_single_blocks": 2})]


@pytest.fixture(scope="module")
def fake_runs(tmp_path_factory):
    """The three spawned processes, started before the reference's cells
    build and joined by the first test that reads each."""
    return {"launch": spawn_alone(launch_rank, CELLS, PARITY),
            "analysis": spawn_alone(analysis_rank, ANALYSIS),
            "values": spawn(one_rank_values_rank, 1,
                            tmp_path_factory.mktemp("launch"), VALUES),
            "mesh": spawn(mesh_values_rank, 4,
                          tmp_path_factory.mktemp("mesh"), MESH_CASES,
                          MOE_CASE)}


def j_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))
    return sorted(((jshd._path_str(kp), x) for kp, x in flat),
                  key=lambda t: t[0])


def t_leaves(tree):
    out = []
    shd.tree_map_with_path(lambda kp, x: out.append((shd._path_str(kp), x)),
                           tree)
    return sorted(out, key=lambda t: t[0])


def t_dtype(x) -> str:
    # the key: two uint32 words, held in int64 (scene/prng.py)
    if x.dtype == torch.int64 and tuple(x.shape) == KEY_SDS.shape:
        return "uint32"
    return DTYPES[x.dtype]


def assert_cells_equal(arch, mesh_shape, monkeypatch):
    for k in ("REPRO_SP_THRESHOLD", "REPRO_SERVE_TP_ONLY",
              "REPRO_SERVE_REPLICATED"):
        monkeypatch.delenv(k, raising=False)
    jm, tm = j_abstract(*mesh_shape), make_abstract_mesh(*mesh_shape)
    for sh in j_shapes_for(j_config(arch)):
        jc, tc = j_build_cell(arch, sh.name, jm), build_cell(arch, sh.name,
                                                             tm)
        assert (tc.arch, tc.shape) == (jc.arch, jc.shape)
        assert [(p, tuple(x.shape), t_dtype(x))
                for p, x in t_leaves(tc.args)] == \
            [(p, tuple(x.shape), str(x.dtype))
             for p, x in j_leaves(jc.args)], sh.name
        for name in ("in_shardings", "out_shardings"):
            assert [(p, tuple(s.spec))
                    for p, s in t_leaves(getattr(tc, name))] == \
                [(p, tuple(s.spec))
                 for p, s in j_leaves(getattr(jc, name))], (sh.name, name)


@pytest.mark.parametrize("arch", J_ARCHS)
def test_build_cell_matches_reference(arch, fake_runs, monkeypatch):
    """Every shape of the arch on the single-pod (16, 16) mesh."""
    assert_cells_equal(arch, SINGLE, monkeypatch)


@pytest.mark.parametrize("arch", MULTI_ARCHS)
def test_build_cell_multi_pod_matches_reference(arch, fake_runs,
                                                monkeypatch):
    assert_cells_equal(arch, MULTI, monkeypatch)


def test_sp_threshold_is_an_argument():
    """sp_threshold moves the sequence-parallel cutoff as
    REPRO_SP_THRESHOLD does in the reference: decode_32k's cache shards
    its sequence axis over `model` once the threshold is 32768."""
    mesh = make_abstract_mesh(*SINGLE)
    cache_spec = [tuple(s.spec) for s in build_cell(
        "stablelm-3b", "decode_32k", mesh,
        sp_threshold=32768).in_shardings[2]]
    assert cache_spec[0] == (None, "data", "model", None, None)
    assert [tuple(s.spec) for s in build_cell(
        "stablelm-3b", "decode_32k", mesh).in_shardings[2]][0] == \
        (None, "data", None, "model", None)


@pytest.mark.parametrize("arch", ["stablelm-3b", "deepseek-v3-671b",
                                  "kimi-k2-1t-a32b"])
def test_cache_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    for batch, seq in ((1, 524288), (128, 32768), (3, 17)):
        got = kvc.cache_specs(cfg, batch, seq)
        want = jkvc.cache_specs(jcfg, batch, seq)
        assert type(got).__name__ == type(want).__name__
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            assert DTYPES[g.dtype] == str(w.dtype)
    got = kvc.cache_specs(cfg, 2, 8, dtype=torch.float32)
    assert got[0].dtype == torch.float32


def _hlo_line(kind: str, shape: tuple, dtype: str) -> str:
    ty = {"torch.float32": "f32", "torch.bfloat16": "bf16"}[dtype]
    dims = ",".join(str(d) for d in shape)
    return (f"  %c = {ty}[{dims}]{{1,0}} {kind}({ty}[{dims}]{{1,0}} %p), "
            f"replica_groups={{}}")


def test_collective_bytes_match_reference_parser(fake_runs):
    """S(0)->Replicate (all-gather), Partial->Replicate (all-reduce),
    Partial->Shard (reduce-scatter) and Shard(0)->Shard(1) (all-to-all)
    of known DTensors: the port's bytes equal the reference's parser on
    an HLO line of the same output type."""
    cases = fake_runs["launch"].join()[0]["collectives"]
    assert set(cases) == {"S(0)->R", "P->R", "P->S(0)", "S(0)->S(1)"}
    for name, (got, out_shape, dtype) in cases.items():
        (kind,) = got
        assert got == jshd.collective_bytes(
            _hlo_line(kind, out_shape, dtype)), name
    assert [next(iter(cases[n][0])) for n in sorted(cases)] == [
        "all-reduce", "reduce-scatter", "all-gather", "all-to-all"]
    assert shd.collective_bytes([("all-gather", 4), ("all-gather", 6),
                                 ("all-reduce", 2)]) == {
        "all-gather": 10, "all-reduce": 2}


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(c))
def test_dryrun_smoke_cell(cell, fake_runs):
    r = fake_runs["launch"].join()[0]["cells"][cell]
    assert set(r) == RESULT_KEYS
    assert (r["mesh"], r["chips"]) == ("2x2", 4)
    assert r["flops"] > 0 and r["bytes_accessed"] > 0
    assert r["collective_total"] == sum(r["collective_bytes"].values())
    assert set(r["collective_bytes"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert r["bytes_per_device"] == (r["argument_size_in_bytes"]
                                     + r["temp_size_in_bytes"])
    assert r["argument_size_in_bytes"] > 0 and r["output_size_in_bytes"] > 0


@pytest.mark.parametrize("cell", PARITY, ids=lambda c: "-".join(c))
def test_real_run_flops_equal_dry_run(cell, fake_runs):
    dry, real = fake_runs["launch"].join()[0]["parity"][cell]
    assert dry == real > 0


@pytest.mark.parametrize("case", ANALYSIS, ids=lambda c: "-".join(c[:2]))
def test_analysis_extrapolation_is_exact(case, fake_runs):
    ext, direct = fake_runs["analysis"].join()[0][case[:2]]
    for k in ("flops", "bytes_accessed", "collective_total"):
        assert ext[k] == pytest.approx(direct[k], rel=1e-12, abs=0), k
    assert "extrapolated_from" in ext and "full_depth" in ext
    assert ext["mesh"] == "2x2"


@pytest.mark.parametrize("cell", VALUES, ids=lambda c: "-".join(c))
def test_one_rank_mesh_run_equals_plain(cell, fake_runs):
    n_leaves, worst = fake_runs["values"].join()[0][cell]
    assert n_leaves >= 1 and worst == 0.0


def _as_torch(tree):
    return shd.tree_map_with_path(
        lambda _, a: torch.as_tensor(a) if hasattr(a, "dtype") else a, tree)


def _assert_close(got, want, label):
    for (path, g), (wpath, w) in zip(t_leaves(got), t_leaves(want)):
        assert path == wpath, label
        g, w = torch.as_tensor(g), torch.as_tensor(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (label, path)
        if not w.is_floating_point():
            assert torch.equal(g, w), (label, path)
            continue
        top = float(w.abs().max())
        err = float((g.double() - w.double()).abs().max())
        assert err <= MESH_REL * top, (label, path, err, top)


@pytest.mark.parametrize("case", MESH_CASES,
                         ids=lambda c: f"{c[0]}-{c[1]}-sp{c[2]}")
def test_mesh_run_equals_plain(case, fake_runs):
    results = fake_runs["mesh"].join()[0]
    keys = [k for k in results if k[:3] == case]
    assert len(keys) == (2 if "decode" in case[1] or "500k" in case[1]
                         else 1)
    for key in keys:
        got, want = results[key]
        if case[1] in MESH_TRAIN:
            check_step(_as_torch(got), _as_torch(want), torch.float32,
                       str(key))
        else:
            _assert_close(got, want, key)


def test_moe_layer_on_mesh_equals_plain(fake_runs):
    """The global dispatch: capacity from the global token count, the
    plain layer's dropped assignments, and the global aux loss."""
    (y, (aux, dropped)), (y0, (aux0, dropped0)) = \
        fake_runs["mesh"].join()[0]["moe"]
    assert dropped0 > 0           # the case drops assignments
    assert dropped == dropped0
    assert aux == pytest.approx(aux0, rel=1e-6)
    _assert_close({"y": y}, {"y": y0}, "moe")


@pytest.mark.parametrize("hook", ["alltoall", "propagation"])
def test_collective_recorder_refuses_a_torch_without_its_hooks(
        hook, monkeypatch):
    """The recorder wraps two DTensor internals; where a PyTorch lacks
    one it raises (its counts would silently change) and leaves nothing
    wrapped."""
    from torch.distributed.tensor import placement_types as pt
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    prop = "_propagate_tensor_meta_non_cached"
    owner, name = {"alltoall": (pt, "shard_dim_alltoall"),
                   "propagation": (ShardingPropagator, prop)}[hook]
    before = (pt.shard_dim_alltoall, getattr(ShardingPropagator, prop))
    with monkeypatch.context() as m:
        m.delattr(owner, name)
        with pytest.raises(RuntimeError, match=name):
            with shd.CollectiveRecorder():
                pass
    assert (pt.shard_dim_alltoall, getattr(ShardingPropagator, prop)) \
        == before


def test_models_import_no_layer_above_them():
    """The models lay tensors out with models/layout.py: importing every
    model module loads none of the trainer, the sharding rules or the
    launchers."""
    import os
    import subprocess
    import sys

    code = ("import sys\n"
            "import repro_torch.models.kvcache, repro_torch.models.moe_lm\n"
            "import repro_torch.models.vit, repro_torch.models.swin\n"
            "import repro_torch.models.diffusion, repro_torch.models.mmdit\n"
            "print(sorted(m for m in sys.modules if m.startswith(("
            "'repro_torch.launch', 'repro_torch.distributed', "
            "'repro_torch.train.trainer'))))\n")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = {**os.environ, "PYTHONPATH": src}
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert out.strip() == "[]"
