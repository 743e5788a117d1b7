"""The port's training substrate (`repro_torch.train`, `launch/train.py`)
against the JAX package's on the same numpy-seeded inputs: AdamW with
its global-norm clip and Adafactor, activation recomputation
(`cfg.remat`), checkpoints in the reference's format both ways (paths,
manifest, shard bytes), the msgpack subset, the host-side fault,
compression and elastic helpers (the reference's
tests/test_train_substrate.py cases, hypothesis included), and the
launcher's synthetic batches and resume. One train step of every family
is tests/test_torch_train_families.py.

Tolerances: the optimizers 1e-6 relative on float32 leaves (the same
gradients on both sides; powers and roots round in another library),
one bf16 ulp on bf16 parameters (an update rounds either way at a tie),
and AdamW's elements whose gradient is at round-off level (|g| < 1e-7,
so g / (|g| + 1e-8) is noise) 3 lr a step; remat bit-equal; checkpoints
and synthetic token batches bit-equal; normal draws within prng.normal's
erfinv ulps (1e-6).
"""
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro.train import optim as joptim  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.scene import prng  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import compression as comp  # noqa: E402
from repro_torch.train import optim, trainer  # noqa: E402
from repro_torch.train.elastic import (  # noqa: E402
    rebalance_batch,
    valid_submesh_sizes,
)
from repro_torch.train.fault import (  # noqa: E402
    HeartbeatTable,
    RestartPolicy,
    deadline_for_step,
)
from repro_torch.train.optim import tree_leaves, tree_map  # noqa: E402
from test_torch_train_families import to_jax, to_torch  # noqa: E402
from torch_train_inputs import (  # noqa: E402
    numpy_batch,
    smoke,
    torch_batch,
    train_params,
)

LR = 0.01
BF16_ULP = 2.0 ** -7


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

SHAPES = {"s": (), "v": (7,), "m": (5, 6), "t": (2, 3, 4)}


def _opt_tree(rng, *, scale=1.0, tiny=False):
    """{"f32": {...}, "bf16": {...}} numpy float32 leaves of rank 0-3;
    with `tiny` the "t" leaves are at round-off scale (1e-9)."""
    out = {}
    for kind in ("f32", "bf16"):
        out[kind] = {k: (rng.normal(0, scale, s)
                         * (1e-9 if tiny and k == "t" else 1.0)
                         ).astype(np.float32) for k, s in SHAPES.items()}
    return out


def _both(tree):
    """(port tree, JAX tree): "bf16" leaves in bf16 on both sides."""
    port = {kind: {k: torch.as_tensor(a).to(
        torch.bfloat16 if kind == "bf16" else torch.float32)
        for k, a in d.items()} for kind, d in tree.items()}
    return port, to_jax(port)


def _assert_params(got, want, rough=None, steps=1):
    for i, (g, w) in enumerate(zip(tree_leaves(got),
                                   tree_leaves(to_torch(want)))):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).abs()
        if g.dtype == torch.bfloat16:
            tol = torch.clamp(BF16_ULP * w.float().abs(), min=1e-6)
        else:
            tol = 1e-6 * torch.clamp(w.abs(), min=1.0)
        if rough is not None and rough[i]:
            tol = torch.maximum(tol, torch.full_like(tol, 3 * LR * steps))
        assert bool((err <= tol).all()), (i, float(err.max()))


def _assert_close(got, want, rel=1e-6):
    for g, w in zip(tree_leaves(got), tree_leaves(to_torch(want))):
        assert g.dtype == w.dtype and g.shape == w.shape
        top = max(float(w.float().abs().max()), 1e-30)
        assert float((g.float() - w.float()).abs().max()) <= rel * top


@pytest.mark.parametrize("grad_clip", [1.0, 0.05, None],
                         ids=["clip1", "clip0.05", "noclip"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_adamw_matches_jax(grad_clip, masked):
    """Three AdamW steps with weight decay on bf16 and float32 leaves of
    rank 0-3 (one leaf at round-off scale), the clip on and off, with
    and without a mask."""
    rng = np.random.default_rng(0)
    tp, jp = _both(_opt_tree(rng))
    mask = None
    if masked:
        mask = tree_map(lambda _: True, tp)
        mask["f32"]["m"] = mask["bf16"]["v"] = False
    ts, js = optim.adamw_init(tp, mask), joptim.adamw_init(jp, mask)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    rough = [path.endswith("['t']") for path in ckpt.tree_paths(tp)]
    for it in range(1, 4):
        g = _opt_tree(rng, scale=3.0, tiny=True)
        tg, jg = _both(g)
        tp, ts = optim.adamw_update(tp, tg, ts, lr=LR, weight_decay=0.01,
                                    mask=mask, grad_clip=grad_clip)
        jp, js = joptim.adamw_update(jp, jg, js, lr=LR, weight_decay=0.01,
                                     mask=mask, grad_clip=grad_clip)
        assert int(ts.step) == int(js.step) == it
        _assert_params(tp, jp, rough, it)
        for got, want in ((ts.mu, js.mu), (ts.nu, js.nu)):
            _assert_close(got, want, rel=1e-6)
    if masked:
        assert ts.mu["f32"]["m"].shape == ()
        assert torch.equal(tp["f32"]["m"], _both(_opt_tree(
            np.random.default_rng(0)))[0]["f32"]["m"])


def test_adamw_clip_scales_every_leaf_in_its_dtype():
    """The clip's scale is the global norm over every leaf (masked ones
    too) and is rounded to each gradient's dtype before the product."""
    p = {"a": torch.zeros(3, dtype=torch.bfloat16), "b": torch.zeros(2)}
    g = {"a": torch.tensor([3.0, 0.0, 0.0], dtype=torch.bfloat16),
         "b": torch.tensor([0.0, 4.0])}
    mask = {"a": False, "b": True}
    _, st_ = optim.adamw_update(p, g, optim.adamw_init(p, mask), lr=0.0,
                                b1=0.0, mask=mask, grad_clip=1.0)
    assert float(st_.mu["b"][1]) == pytest.approx(4.0 / 5.0, rel=1e-7)
    assert float(optim.global_norm(g)) == 5.0


@pytest.mark.parametrize("which", ["adamw", "adafactor"])
def test_donated_update_equals_functional(which):
    """With donate the update gives the same values, written into the
    given parameter and state tensors where dtypes allow (bf16 AdamW
    moments become new float32 tensors at the first step and are
    donated from the second); the gradients are left as they were."""
    rng = np.random.default_rng(2)
    tp, _ = _both(_opt_tree(rng))
    init = optim.adamw_init if which == "adamw" else optim.adafactor_init
    upd = optim.adamw_update if which == "adamw" else optim.adafactor_update
    fp, fs = tp, init(tp)
    dp = tree_map(torch.clone, tp)
    ds = init(dp)
    for _ in range(2):
        tg, _ = _both(_opt_tree(rng, scale=2.0))
        g_before = tree_map(torch.clone, tg)
        old_p, old_s = tree_leaves(dp), [tree_leaves(x) for x in ds[1:]]
        fp, fs = upd(fp, tg, fs, lr=LR)
        dp, ds = upd(dp, tg, ds, lr=LR, donate=True)
        for a, b in zip(tree_leaves([fp] + list(fs[1:])),
                        tree_leaves([dp] + list(ds[1:]))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert all(a is b for a, b in zip(tree_leaves(dp), old_p))
        for new, old in zip(ds[1:], old_s):
            for a, b in zip(tree_leaves(new), old):
                assert (a is b) == (a.dtype == b.dtype)
        for a, b in zip(tree_leaves(tg), tree_leaves(g_before)):
            assert torch.equal(a, b)


def test_adafactor_matches_jax():
    """Three Adafactor steps on bf16 and float32 leaves of rank 0-3:
    parameters and every factor."""
    rng = np.random.default_rng(1)
    tp, jp = _both(_opt_tree(rng))
    ts, js = optim.adafactor_init(tp), joptim.adafactor_init(jp)
    for it in range(1, 4):
        tg, jg = _both(_opt_tree(rng, scale=2.0))
        tp, ts = optim.adafactor_update(tp, tg, ts, lr=LR)
        jp, js = joptim.adafactor_update(jp, jg, js, lr=LR)
        assert int(ts.step) == int(js.step) == it
        assert ts.step.dtype == torch.int32
        _assert_params(tp, jp)
        for got, want in zip(ts[1:], js[1:]):
            _assert_close(got, want, rel=1e-6)


# the reference's tests/test_train_substrate.py optimizer cases

def _toy_params():
    rng = np.random.default_rng(0)
    return {"layer": {"w": torch.as_tensor(rng.normal(size=(8, 4)),
                                           dtype=torch.float32),
                      "b": torch.zeros(4)},
            "head": {"w": torch.as_tensor(rng.normal(size=(4, 2)),
                                          dtype=torch.float32)}}


def test_adamw_masking_freezes_leaves():
    params = _toy_params()
    mask = {"layer": {"w": False, "b": False}, "head": {"w": True}}
    state = optim.adamw_init(params, mask)
    grads = tree_map(torch.ones_like, params)
    p2, _ = optim.adamw_update(params, grads, state, lr=0.1, mask=mask)
    assert torch.equal(p2["layer"]["w"], params["layer"]["w"])
    assert bool((p2["head"]["w"] != params["head"]["w"]).any())
    assert state.mu["layer"]["w"].shape == ()
    assert state.mu["head"]["w"].shape == (4, 2)


def test_adamw_descends_quadratic():
    p = {"w": torch.tensor([3.0, -2.0])}
    st_ = optim.adamw_init(p)
    for _ in range(200):
        p, st_ = optim.adamw_update(p, {"w": 2 * p["w"]}, st_, lr=0.05)
    assert float(p["w"].abs().max()) < 0.1


def test_adafactor_memory_is_factored():
    st_ = optim.adafactor_init({"w": torch.zeros(512, 256)})
    assert st_.vr["w"].shape == (512,)
    assert st_.vc["w"].shape == (256,)
    assert st_.v["w"].shape == ()
    assert 512 + 256 < 2 * 512 * 256 / 100


def test_adafactor_descends_quadratic():
    p = {"w": torch.full((4, 4), 3.0)}
    st_ = optim.adafactor_init(p)
    for _ in range(300):
        p, st_ = optim.adafactor_update(p, {"w": 2 * p["w"]}, st_, lr=0.05)
    assert float(p["w"].abs().max()) < 0.2


# ---------------------------------------------------------------------------
# activation recomputation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-3b", "deepseek-v3-671b",
                                  "vit-b16", "dit-l2", "flux-dev"])
def test_remat_gradients_bit_equal(arch):
    """cfg.remat on and off: the same loss and bit-equal gradients (the
    layers are recomputed, not changed), in float32."""
    import dataclasses

    cfg = smoke(arch, torch.float32)
    params = train_params(cfg)
    batch = torch_batch(numpy_batch(cfg))
    out = []
    for flag in (True, False):
        c = dataclasses.replace(cfg, remat=flag)
        out.append(trainer.value_and_grad(trainer._loss_for(c), params,
                                          batch, prng.PRNGKey(3)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        assert torch.equal(a, b)


def test_remat_recomputes_only_under_grad():
    """With grad off the layer runs once; with grad on and remat it runs
    again in the backward pass."""
    from repro_torch.models.layers import remat

    calls = []

    def layer(w, x):
        calls.append(1)
        return torch.tanh(x @ w)

    w = torch.randn(4, 4, requires_grad=True)
    x = torch.randn(2, 4)
    with torch.no_grad():
        remat(True, layer, w, x)
    assert len(calls) == 1
    remat(True, layer, w, x).sum().backward()
    assert len(calls) == 3
    remat(False, layer, w, x).sum().backward()
    assert len(calls) == 4


# ---------------------------------------------------------------------------
# checkpoints in the reference's format
# ---------------------------------------------------------------------------

def _port_state(arch, dtype, optimizer="adamw", step=True):
    """(params, opt) of arch's SMOKE config after one optimizer update
    on numpy gradients (AdamW's moments then float32)."""
    cfg = smoke(arch, dtype)
    params = train_params(cfg)
    ts = trainer.make_train_step(cfg, optimizer=optimizer)
    opt = ts.init_opt(params)
    if step:
        rng = np.random.default_rng(9)
        grads = tree_map(lambda p: torch.as_tensor(
            rng.normal(size=p.shape).astype(np.float32)).to(p.dtype), params)
        upd = (optim.adafactor_update if optimizer == "adafactor"
               else optim.adamw_update)
        params, opt = upd(params, grads, opt, lr=1e-3)
    return params, opt


def _to_jax_state(opt):
    cls = getattr(joptim, type(opt).__name__)
    return cls(jnp.asarray(opt.step.numpy()), *[to_jax(x) for x in opt[1:]])


@pytest.mark.parametrize("arch,optimizer", [
    ("stablelm-3b", "adamw"), ("deepseek-v3-671b", "adamw"),
    ("swin-b", "adafactor"), ("madeye-approx", "adamw"),
    ("flux-dev", "adamw")])
def test_tree_paths_match_keystr(arch, optimizer):
    """tree_paths and treedef_str of (params, opt) equal
    jax.tree_util.keystr's and str(jax.tree.structure)'s: sorted dict
    keys, list indices (the MoE LM's dense layers, Swin's stages and
    blocks), NamedTuple fields as attributes."""
    tp, to = _port_state(arch, torch.bfloat16, optimizer, step=False)
    jt = (to_jax(tp), _to_jax_state(to))
    want = [jax.tree_util.keystr(k) for k, _ in
            jax.tree_util.tree_flatten_with_path(jt)[0]]
    assert ckpt.tree_paths((tp, to)) == want
    assert ckpt.treedef_str((tp, to)) == str(jax.tree.structure(jt))


def test_treedef_str_edge_cases():
    x = jnp.zeros(1)
    for tree in [(x,), [x, (x, [x])], {"b": (x,), "a": [], "c": x}, (), {}]:
        port = jax.tree.map(lambda a: torch.zeros(1), tree)
        assert ckpt.treedef_str(port) == str(jax.tree.structure(tree))
        assert ckpt.tree_paths(port) == [
            jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", ["stablelm-3b", "deepseek-v3-671b"])
def test_reference_checkpoint_restores_in_port(tmp_path, arch):
    """repro.train.checkpoint.save of (params, AdamState) after an AdamW
    step (bf16 params, float32 moments, the float32 router) restores in
    the port bit for bit, in the file's dtypes whatever `like` holds,
    with the manifest's paths equal to tree_paths."""
    tp, to = _port_state(arch, torch.bfloat16)
    jt = (to_jax(tp), _to_jax_state(to))
    d = str(tmp_path)
    jckpt.save(d, 7, jt, extra={"arch": arch})
    assert ckpt.latest_step(d) == 7
    like = _port_state(arch, torch.bfloat16, step=False)
    assert tree_leaves(like[1].mu)[0].dtype == torch.bfloat16
    (rp, ro), manifest = ckpt.restore(d, 7, like)
    assert manifest["paths"] == ckpt.tree_paths(like)
    assert manifest["extra"] == {"arch": arch} and manifest["step"] == 7
    assert type(ro) is optim.AdamState
    for (path, got), (_, want) in zip(
            ckpt.tree_flatten_with_paths((rp, ro)),
            ckpt.tree_flatten_with_paths((tp, to))):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path
    assert {str(ro.step.dtype), str(tree_leaves(ro.mu)[0].dtype)} == {
        "torch.int32", "torch.float32"}


@pytest.mark.parametrize("arch,optimizer", [
    ("deepseek-v3-671b", "adamw"), ("vit-b16", "adafactor"),
    ("madeye-approx", "adamw")])
def test_port_checkpoint_restores_in_reference(tmp_path, arch, optimizer):
    """The port's save of (params, opt) restores in repro bit for bit;
    the port writes the manifest and the shard byte for byte as the
    reference writes the same tree (bool and int32 leaves included)."""
    tp, to = _port_state(arch, torch.bfloat16, optimizer)
    tree = (tp, to, {"flags": torch.tensor([True, False, True]),
                     "count": torch.arange(5, dtype=torch.int32)})
    jt = (to_jax(tp), _to_jax_state(to),
          {"flags": jnp.asarray([True, False, True]),
           "count": jnp.arange(5, dtype=jnp.int32)})
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    path = ckpt.save(port_dir, 12, tree, extra={"k": 1})
    assert path.endswith("step_00000012") and not os.path.exists(
        path + ".tmp-0")
    jckpt.save(ref_dir, 12, jt, extra={"k": 1})
    names = ["manifest.json", "shard_00000.msgpack"]
    for name in names:
        with open(os.path.join(port_dir, "step_00000012", name), "rb") as f:
            a = f.read()
        with open(os.path.join(ref_dir, "step_00000012", name), "rb") as f:
            b = f.read()
        assert a == b, name
    restored, manifest = jckpt.restore(port_dir, 12, jt)
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(jt)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(np.asarray(got.astype(jnp.float32)),
                                      np.asarray(want.astype(jnp.float32)))
    assert json.load(open(os.path.join(port_dir, "step_00000012",
                                       "manifest.json")))["n_processes"] == 1


def test_restore_places_specs_and_tensors(tmp_path):
    """A TensorSpec leaf of `like` restores on the device asked for, a
    tensor leaf on its own; without a card and without device="cpu" a
    spec leaf raises."""
    tree = {"a": torch.arange(4, dtype=torch.int32),
            "b": torch.ones(2, 3, dtype=torch.bfloat16)}
    d = str(tmp_path)
    ckpt.save(d, 1, tree)
    like = {"a": trainer.TensorSpec((4,), torch.int32),
            "b": torch.zeros(1)}
    out, _ = ckpt.restore(d, 1, like, device="cpu")
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"],
                                                            tree["b"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.restore(d, 1, like)


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"params": {"w": torch.as_tensor(rng.normal(size=(16, 8)),
                                            dtype=torch.float32),
                       "b": torch.arange(8, dtype=torch.float32)},
            "step": torch.tensor(7, dtype=torch.int32)}
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 100, tree)
    assert ckpt.latest_step(d) == 100
    restored, manifest = ckpt.restore(d, 100, tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert torch.equal(a, b)
    assert manifest["step"] == 100


def test_checkpoint_prune_keeps_newest(tmp_path):
    d = str(tmp_path / "ckpt")
    for s in [10, 20, 30, 40, 50]:
        ckpt.save(d, s, {"w": torch.zeros(4)})
    ckpt.prune_old(d, keep=2)
    assert ckpt.latest_step(d) == 50
    assert len([n for n in os.listdir(d) if n.startswith("step_")]) == 2


def test_checkpoint_atomicity(tmp_path):
    """A half-written tmp dir is never a checkpoint."""
    d = str(tmp_path / "ckpt")
    ckpt.save(d, 5, {"w": torch.zeros(4)})
    os.makedirs(os.path.join(d, "step_00000009.tmp-0"), exist_ok=True)
    assert ckpt.latest_step(d) == 5
    assert ckpt.latest_step(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------

@pytest.fixture
def msgpack():
    return pytest.importorskip("msgpack")


def _key(i: int, n: int) -> str:
    """A key of exactly n characters, distinct for each i."""
    digits = "0123456789abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
    s = ""
    while True:
        s = digits[i % 62] + s
        i //= 62
        if not i:
            return s.rjust(n, "_")


@pytest.mark.parametrize("n_keys,key_len,value_len", [
    (0, 1, 0), (3, 5, 10), (15, 31, 255), (16, 32, 256),
    (40, 255, 65535), (5, 256, 65536), (2, 70000, 3), (70000, 4, 1)],
    ids=["empty", "fix", "fix-edge", "map16-str8-bin16", "bin16-edge",
         "str16-bin32", "str32", "map32"])
def test_msgpack_subset_matches_packb(msgpack, n_keys, key_len,
                                     value_len):
    """write_map is byte-equal to msgpack.packb(use_bin_type=True) at
    every header width the format can meet, and unpack_map reads back
    what msgpack.unpackb does."""
    rng = np.random.default_rng(n_keys + key_len)
    payload = {_key(i, key_len): rng.integers(0, 256, value_len,
                                              np.uint8).tobytes()
               for i in range(n_keys)}
    assert len(payload) == n_keys and all(len(k) == key_len
                                          for k in payload)
    buf = io.BytesIO()
    ckpt.write_map(buf, payload.items())
    packed = buf.getvalue()
    assert packed == msgpack.packb(payload, use_bin_type=True)
    back = ckpt.unpack_map(packed)
    assert list(back) == list(payload)
    assert {k: bytes(v) for k, v in back.items()} == \
        msgpack.unpackb(packed, raw=False)


@pytest.mark.parametrize("obj", [[1, 2], {"a": 1}, {"a": "text"},
                                 {b"raw": b"x"}, 7],
                         ids=["array", "int-value", "str-value", "bin-key",
                              "int"])
def test_msgpack_subset_refuses_other_types(msgpack, obj):
    with pytest.raises(ValueError, match="msgpack"):
        ckpt.unpack_map(msgpack.packb(obj, use_bin_type=True))


def test_msgpack_subset_refuses_truncated_and_trailing(msgpack):
    packed = msgpack.packb({"a": b"xyz"}, use_bin_type=True)
    with pytest.raises(ValueError, match="truncated"):
        ckpt.unpack_map(packed[:-1])
    with pytest.raises(ValueError, match="trailing"):
        ckpt.unpack_map(packed + b"\x00")


# ---------------------------------------------------------------------------
# gradient compression with error feedback
# ---------------------------------------------------------------------------

@given(st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_quantize_roundtrip_bounded(seed):
    x = torch.as_tensor(np.random.default_rng(seed).normal(0, 3, 64),
                        dtype=torch.float32)
    q, scale = comp.quantize_int8(x)
    assert q.dtype == torch.int8
    err = (comp.dequantize_int8(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) / 2 + 1e-6


@given(st.integers(0, 10_000))
@settings(max_examples=20, deadline=None)
def test_compress_matches_jax(seed):
    """compress over a tree, two EF rounds: q bit-equal, scales and
    residuals within 1 float32 ulp of the reference's."""
    rng = np.random.default_rng(seed)
    g = {"a": rng.normal(0, 2, (5, 7)).astype(np.float32),
         "b": [rng.normal(0, 1e-3, 9).astype(np.float32)]}
    tg = tree_map(torch.as_tensor, g)
    jg = jax.tree.map(jnp.asarray, g)
    ts, js = comp.init_ef(tg), jcomp.init_ef(jg)
    for _ in range(2):
        tq, tsc, ts = comp.compress(tg, ts)
        jq, jsc, js = jcomp.compress(jg, js)
        for a, b in zip(tree_leaves(tq), jax.tree.leaves(jq)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(tree_leaves(tsc) + tree_leaves(ts.error),
                        jax.tree.leaves(jsc) + jax.tree.leaves(js.error)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7,
                                       atol=1e-12)
    deq = comp.decompress(tq, tsc)
    np.testing.assert_allclose(deq["a"].numpy(),
                               np.asarray(jcomp.decompress(jq, jsc)["a"]),
                               rtol=2e-7)


def test_error_feedback_is_contraction():
    """With a constant gradient the EF residual stays bounded and the mean
    dequantized signal converges to the true gradient."""
    g = {"w": torch.as_tensor(np.random.default_rng(0).normal(size=128),
                              dtype=torch.float32)}
    state = comp.init_ef(g)
    acc = torch.zeros(128)
    n = 50
    for _ in range(n):
        qs, scales, state = comp.compress(g, state)
        acc = acc + comp.decompress(qs, scales)["w"]
    np.testing.assert_allclose((acc / n).numpy(), g["w"].numpy(), atol=1e-2)
    assert float(state.error["w"].abs().max()) < 1.0


def test_compression_wire_bytes():
    g = {"w": torch.zeros(1024)}
    qs, _, _ = comp.compress(g, comp.init_ef(g))
    assert qs["w"].numel() * qs["w"].element_size() + 4 < 1024 * 4 / 3.9


# ---------------------------------------------------------------------------
# fault handling, elastic resizing
# ---------------------------------------------------------------------------

def test_heartbeat_detects_dead_hosts():
    hb = HeartbeatTable(n_hosts=4, dead_after_s=10.0)
    now = 1000.0
    for h in range(4):
        hb.beat(h, 0.5, now=now)
    hb.beat(0, 0.5, now=now + 20)
    assert set(hb.dead_hosts(now=now + 20)) == {1, 2, 3}


def test_straggler_detection():
    hb = HeartbeatTable(n_hosts=4)
    for _ in range(20):
        for h in range(4):
            hb.beat(h, 0.1 if h != 2 else 0.5)
    assert hb.stragglers(tolerance=1.5) == [2]


def test_restart_policy_prefers_elastic():
    pol = RestartPolicy()
    assert pol.decide(0, 256, 16) == "continue"
    assert pol.decide(16, 256, 16) == "elastic_shrink"
    assert pol.decide(15, 256, 16) == "full_restart"
    assert RestartPolicy(max_restarts=0).decide(1, 4, 1) == "abort"


def test_restart_backoff_grows():
    pol = RestartPolicy(backoff_base_s=1.0)
    assert pol.backoff_s() < pol.backoff_s() < pol.backoff_s()


def test_deadline_from_history():
    assert deadline_for_step([0.1] * 50) == pytest.approx(1.0)  # the floor
    assert deadline_for_step([2.0] * 50) == pytest.approx(4.0)
    assert deadline_for_step([]) > 0


def test_rebalance_batch():
    assert rebalance_batch(256, old_dp=16, new_dp=12) == 192
    assert 15 in valid_submesh_sizes(240, model_parallel=16)
    assert valid_submesh_sizes(7, model_parallel=2) == [1, 2, 3]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-3b", "vit-b16", "swin-b",
                                  "dit-l2", "flux-dev", "madeye-approx"])
def test_synthetic_batch_matches_jax(arch):
    """synthetic_batch against the reference's in this process (the
    entries' keys fold in hash(name)): integer entries (tokens, labels,
    classes) and flags bit-equal, normal draws within erfinv ulps."""
    cfg, jcfg = smoke(arch), j_smoke(arch)
    kw = (dict(seq_len=24) if cfg.family == "lm"
          else dict(img_res=cfg.img_res))
    shape = ShapeSpec("t", "train", global_batch=3, **kw)
    from repro.configs.base import ShapeSpec as JShape

    got = tlaunch.synthetic_batch(cfg, shape, prng.fold_in(
        prng.PRNGKey(0), 5))
    want = jlaunch.synthetic_batch(jcfg, JShape("t", "train",
                                                global_batch=3, **kw),
                                   jax.random.fold_in(
                                       jax.random.PRNGKey(0), 5))
    assert list(got) == list(want)
    for k in got:
        w = np.asarray(want[k])
        assert tuple(got[k].shape) == w.shape, k
        assert str(got[k].dtype).removeprefix("torch.") == str(w.dtype), k
        if w.dtype.kind == "f":
            np.testing.assert_allclose(got[k].numpy(), w, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k].numpy(), w)
    if cfg.family == "lm":
        assert torch.equal(got["labels"], torch.roll(got["tokens"], -1, -1))


def test_train_loop_resumes_across_packages(tmp_path, capsys):
    """The reference's train_loop writes step 2; the port's resumes it
    (prints "restored checkpoint step 2") and writes step 3; the
    reference's resumes that."""
    from repro.configs.base import ShapeSpec as JShape

    cfg, jcfg = smoke("vit-b16"), j_smoke("vit-b16")
    d = str(tmp_path / "ckpt")
    jlaunch.train_loop(jcfg, JShape("t", "train", img_res=32,
                                    global_batch=4),
                       steps=2, lr=1e-3, ckpt_dir=d, log_every=1)
    capsys.readouterr()
    params, opt = tlaunch.train_loop(
        cfg, ShapeSpec("t", "train", img_res=32, global_batch=4), steps=3,
        lr=1e-3, ckpt_dir=d, log_every=1, device="cpu")
    out = capsys.readouterr().out
    assert "restored checkpoint step 2" in out
    assert "step     2 loss" in out and "step     1 loss" not in out
    assert ckpt.latest_step(d) == 3
    assert int(opt.step) == 3
    jlaunch.train_loop(jcfg, JShape("t", "train", img_res=32,
                                    global_batch=4),
                       steps=4, lr=1e-3, ckpt_dir=d, log_every=1)
    assert "restored checkpoint step 3" in capsys.readouterr().out


def test_train_main_runs_on_cpu_and_needs_a_card_otherwise(tmp_path,
                                                           capsys):
    d = str(tmp_path)
    tlaunch.main(["--arch", "stablelm-3b", "--smoke", "--steps", "3",
                  "--batch", "2", "--seq", "8", "--ckpt-dir", d,
                  "--device", "cpu"])
    assert ckpt.latest_step(d) == 3
    assert "step     0 loss" in capsys.readouterr().out
    manifest = json.load(open(os.path.join(d, "step_00000003",
                                           "manifest.json")))
    assert manifest["paths"][0] == "[0]['embed']['table']"
    assert manifest["meta"]["[1].step"] == {"shape": [], "dtype": "int32"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tlaunch.main(["--arch", "vit-b16", "--smoke", "--steps", "1"])


def test_make_train_step_refuses_unknown_optimizer():
    with pytest.raises(ValueError, match="adamw | adafactor"):
        trainer.make_train_step(smoke("vit-b16"), optimizer="lion")
