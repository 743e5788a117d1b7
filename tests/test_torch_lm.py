"""The port's LM half of the model zoo against the JAX package on the
same numpy-seeded weights and tokens, at the four SMOKE configs: the
dense LM (`lm_forward`, `gqa_prefill`, `gqa_decode_step`), the MoE LMs
(`moe_lm_forward` with MLA and GQA attention, `mla_prefill` /
`mla_decode_step`, `moe_gqa_prefill` / `moe_gqa_decode_step`), the MoE
router and dispatch, the configs and the weight carrier.

The reference runs jitted with XLA's `xla_allow_excess_precision` off,
so every bf16 op rounds as written, as PyTorch's do (by default XLA
keeps some fused bf16 intermediates in float32, which moves the
reference's own smoke logits by up to 3.3e-2).

Tolerances: float32 (configs replaced to float32 on both sides) 1e-4
on logits of order 3 (sums in another order; measured at most 3.4e-6);
bf16 2e-2, the reference's own (measured 0: bit-equal at all four
configs); the bf16 KV caches within one bf16 ulp (2^-7 relative: two
float32 values ~1e-7 apart may round to neighbouring bf16 values, as
one element of stablelm-3b's float32 prefill cache does, which moves
the decode steps after it by 2.0e-4). So float32 decode is held at
1e-4 from an empty float32 cache on both sides (the caches take any
dtype), where no bf16 rounding enters; the bf16 cache of a float32
model is what the port's own prefill+decode-vs-forward test covers, at
the reference's 2e-2. Router ids, the dispatch order, positions, keep
mask and dropped_frac are exact on identical inputs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs import shapes as j_shapes  # noqa: E402
from repro.models import kvcache as jkv  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import moe_lm as jmlm  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import get_config as t_config  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.models import kvcache as tkv  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import moe_lm as tmlm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402

ARCHS = ["stablelm-3b", "stablelm-12b", "deepseek-v3-671b",
         "kimi-k2-1t-a32b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, PROMPT, TOTAL, MAX_SEQ = 2, 8, 12, 16
BF16_ULP = 2.0 ** -7     # bf16 spacing relative to the value, at most


def _cfgs(arch: str, dtype: str):
    return (dataclasses.replace(j_smoke(arch), dtype=getattr(jnp, dtype)),
            dataclasses.replace(t_smoke(arch), dtype=getattr(torch, dtype)))


def _is_moe(cfg) -> bool:
    return cfg.moe_experts is not None


def _port_init(tc, seed: int = 0):
    """Weights drawn by numpy through the port's init (the same under any
    PyTorch), in the reference's layout."""
    init = tmlm.moe_lm_init if _is_moe(tc) else ttr.lm_init
    return init(np.random.default_rng(seed), tc, device="cpu")


def _to_jax(tree):
    """Port tensors -> JAX arrays of the same dtype (bf16 via float32)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(v) for v in tree]
    dt = jnp.bfloat16 if tree.dtype == torch.bfloat16 else None
    arr = tree.float().numpy() if dt is not None else tree.numpy()
    return jnp.asarray(arr, dtype=dt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jit(fn):
    return jax.jit(fn, compiler_options={"xla_allow_excess_precision": False})


def _fns(cfg):
    """(forward -> logits, prefill, decode step) of one side, by family;
    `cfg` picks the JAX or the port's functions by its dtype's type."""
    port = isinstance(cfg.dtype, torch.dtype)
    kv, mlm, tr = (tkv, tmlm, ttr) if port else (jkv, jmlm, jtr)
    if cfg.mla:
        return (lambda p, t: mlm.moe_lm_forward(p, cfg, t)[0],
                kv.mla_prefill, kv.mla_decode_step)
    if _is_moe(cfg):
        return (lambda p, t: mlm.moe_lm_forward(p, cfg, t)[0],
                kv.moe_gqa_prefill, kv.moe_gqa_decode_step)
    return (lambda p, t: tr.lm_forward(p, cfg, t), kv.gqa_prefill,
            kv.gqa_decode_step)


def _empty_cache(cfg, module, dtype, **kw):
    init = module.init_mla_cache if cfg.mla else module.init_gqa_cache
    return init(cfg, B, MAX_SEQ, dtype=dtype, **kw)


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """Both sides' outputs on the same weights and tokens: forward
    logits (and the MoE aux loss), prefill logits and cache over the
    first PROMPT tokens, then decode logits over the rest; float32
    configs also decode all TOTAL tokens from an empty float32 cache."""
    arch, dtype = request.param
    jc, tc = _cfgs(arch, dtype)
    tp = _port_init(tc)
    jp = _to_jax(tp)
    toks = np.random.default_rng(1).integers(0, tc.vocab, (B, TOTAL))
    jt_, tt_ = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    out = {"arch": arch, "dtype": dtype, "tc": tc, "tp": tp, "toks": tt_}
    jfwd, jpre, jdec = _fns(jc)
    tfwd, tpre, tdec = _fns(tc)
    with torch.no_grad():
        out["fwd"] = (_f32(_jit(jfwd)(jp, jt_)), _f32(tfwd(tp, tt_)))
        if _is_moe(tc):
            out["aux"] = (float(_jit(lambda p, t: jmlm.moe_lm_forward(
                p, jc, t)[1])(jp, jt_)),
                float(tmlm.moe_lm_forward(tp, tc, tt_)[1]))
        jl, jcache = _jit(lambda p, t: jpre(p, jc, t, max_seq=MAX_SEQ))(
            jp, jt_[:, :PROMPT])
        tl, tcache = tpre(tp, tc, tt_[:, :PROMPT], max_seq=MAX_SEQ)
        out["prefill"] = (_f32(jl), _f32(tl))
        # (decode writes into the port's cache in place: keep a copy)
        out["cache"] = ([_f32(c) for c in jcache[:2]],
                        [c.clone() for c in tcache[:2]], int(jcache[2]),
                        tcache[2])
        jstep = _jit(lambda p, t, c: jdec(p, jc, t, c))
        steps = []
        for i in range(PROMPT, TOTAL):
            jl, jcache = jstep(jp, jt_[:, i:i + 1], jcache)
            tl, tcache = tdec(tp, tc, tt_[:, i:i + 1], tcache)
            steps.append((_f32(jl), _f32(tl)))
        out["decode"] = steps
        out["decode_length"] = (int(jcache[2]), tcache[2])
        if dtype == "float32":
            jcache = _empty_cache(jc, jkv, jnp.float32)
            tcache = _empty_cache(tc, tkv, torch.float32, device="cpu")
            steps = []
            for i in range(TOTAL):
                jl, jcache = jstep(jp, jt_[:, i:i + 1], jcache)
                tl, tcache = tdec(tp, tc, tt_[:, i:i + 1], tcache)
                steps.append((_f32(jl), _f32(tl)))
            out["decode_f32_cache"] = steps
    return out


def _max_err(a, b) -> float:
    return float(np.abs(a - b).max())


def test_forward_matches_reference(pair):
    j, t = pair["fwd"]
    assert t.shape == (B, TOTAL, pair["tc"].vocab)
    assert _max_err(j, t) <= TOL[pair["dtype"]]
    if "aux" in pair:
        assert abs(pair["aux"][0] - pair["aux"][1]) <= 1e-5


def test_prefill_matches_reference(pair):
    j, t = pair["prefill"]
    assert t.shape == (B, PROMPT, pair["tc"].vocab)
    assert _max_err(j, t) <= TOL[pair["dtype"]]
    jc, tc, jlen, tlen = pair["cache"]
    assert tlen == jlen == PROMPT
    for a, b in zip(jc, tc):
        assert b.dtype == torch.bfloat16
        b = b.float().numpy()
        assert a.shape == b.shape
        assert np.all(np.abs(a - b) <= BF16_ULP * np.abs(a) + 1e-30)


def test_decode_matches_reference(pair):
    tol = TOL[pair["dtype"]]
    for i, (j, t) in enumerate(pair["decode"]):
        assert t.shape == (B, 1, pair["tc"].vocab)
        if pair["dtype"] == "bfloat16":
            assert _max_err(j, t) <= tol, f"step {PROMPT + i}"
    assert pair["decode_length"] == (TOTAL, TOTAL)
    for i, (j, t) in enumerate(pair.get("decode_f32_cache", [])):
        assert _max_err(j, t) <= tol, f"float32-cache step {i}"


def test_decode_matches_forward(pair):
    """The port's own serving path: prefill then decode, teacher-forced,
    against the full forward at each position (the reference's
    tests/test_models_smoke.py), within its 2e-2: the cache is bf16
    whatever the model's dtype. MoE LMs route each decode token alone
    (capacity never binds at one token), where the forward's 24 tokens
    may overflow an expert, so they are held to the reference's own
    MoE check: shape, finite logits and length."""
    fwd = pair["fwd"][1]
    if not _is_moe(pair["tc"]):
        np.testing.assert_allclose(pair["prefill"][1], fwd[:, :PROMPT],
                                   atol=2e-2)
    for i, (_, t) in enumerate(pair["decode"]):
        assert np.all(np.isfinite(t))
        if not _is_moe(pair["tc"]):
            np.testing.assert_allclose(t[:, 0], fwd[:, PROMPT + i],
                                       atol=2e-2)


def test_last_only_prefill(pair):
    tc, tp, toks = pair["tc"], pair["tp"], pair["toks"]
    pre = _fns(tc)[1]
    with torch.no_grad():
        last, cache = pre(tp, tc, toks[:, :PROMPT], max_seq=MAX_SEQ,
                          last_only=True)
    assert last.shape == (B, 1, tc.vocab)
    # the head's product over 1 row instead of PROMPT rows may sum in
    # another order
    np.testing.assert_allclose(_f32(last)[:, 0], pair["prefill"][1][:, -1],
                               atol=1e-5)
    assert cache.length == PROMPT


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_impl_matches_xla_on_cpu(arch):
    """impl="flash" reaches every layer's attention (the plain flash
    version on CPU tensors; the MLA path pads v to the 24-wide q/k
    heads) and agrees with impl="xla" within 1e-5 in float32."""
    _, tc = _cfgs(arch, "float32")
    tp = _port_init(tc, seed=2)
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, tc.vocab, (B, TOTAL)))
    with torch.no_grad():
        if _is_moe(tc):
            fl, fa = tmlm.moe_lm_forward(tp, tc, toks, impl="flash")
            xl, xa = tmlm.moe_lm_forward(tp, tc, toks, impl="xla")
            assert abs(float(fa) - float(xa)) <= 1e-5
        else:
            fl = ttr.lm_forward(tp, tc, toks, impl="flash")
            xl = ttr.lm_forward(tp, tc, toks, impl="xla")
    assert _max_err(_f32(fl), _f32(xl)) <= 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_matches_reference(dtype):
    for arch in ("stablelm-3b", "kimi-k2-1t-a32b"):
        jc, tc = _cfgs(arch, dtype)
        tp = _port_init(tc, seed=4)
        jp = _to_jax(tp)
        rng = np.random.default_rng(5)
        toks, labels = (rng.integers(0, tc.vocab, (B, TOTAL))
                        for _ in range(2))
        if _is_moe(tc):
            jl = _jit(lambda p, t, y: jmlm.moe_lm_loss(p, jc, t, y))
            tl = tmlm.moe_lm_loss
        else:
            jl = _jit(lambda p, t, y: jtr.lm_loss(p, jc, t, y))
            tl = ttr.lm_loss
        want = float(jl(jp, jnp.asarray(toks, jnp.int32),
                        jnp.asarray(labels, jnp.int32)))
        with torch.no_grad():
            got = float(tl(tp, tc, torch.as_tensor(toks),
                           torch.as_tensor(labels)))
        assert abs(got - want) <= (1e-5 if dtype == "float32" else 2e-3)


# ---------------------------------------------------------------------------
# router and dispatch on identical inputs
# ---------------------------------------------------------------------------

def _moe_case(arch: str, kind: str, seed: int):
    """A MoE layer's weights and input [B, S, D] in float32. kind:
    "random"; "ties" (rows whose router logits tie: zero rows give
    uniform probabilities, two equal router columns give equal pairs);
    "overflow" (every token prefers the same experts)."""
    jc, tc = _cfgs(arch, "float32")
    tp = tmoe.moe_init(np.random.default_rng(seed), tc)
    x = np.random.default_rng(seed + 1).normal(
        0, 1, (2, 16, tc.d_model)).astype(np.float32)
    w = tp["router"]["w"]
    if kind == "ties":
        x[0, :5] = 0.0
        w[:, 3] = w[:, 1]
    elif kind == "overflow":
        w[:, 0] += 1.0
        w[:, 5] += 0.9
        x = np.abs(x)
    return jc, tc, tp, x


MOE_CASES = [(a, k) for a in ("deepseek-v3-671b", "kimi-k2-1t-a32b")
             for k in ("random", "ties", "overflow")]


@pytest.mark.parametrize("arch,kind", MOE_CASES)
def test_router_topk_matches_reference(arch, kind):
    jc, tc, tp, x = _moe_case(arch, kind, seed=7)
    xt = x.reshape(-1, tc.d_model)
    jg, jids, jprobs = jmoe.router_topk(jnp.asarray(tp["router"]["w"]),
                                        jnp.asarray(xt), tc.moe_top_k)
    tg, tids, tprobs = tmoe.router_topk(tp["router"]["w"],
                                        torch.as_tensor(xt), tc.moe_top_k)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               atol=1e-6)


@pytest.mark.parametrize("arch,kind", MOE_CASES)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_dispatch_matches_reference(arch, kind, capacity_factor):
    """The dispatch plan (sorted order, positions within each expert,
    keep mask), dropped_frac and the layer's output and aux loss, on the
    same input; "overflow" and capacity factor 0.5 drop assignments."""
    jc, tc, tp, x = _moe_case(arch, kind, seed=11)
    t = x.shape[0] * x.shape[1]
    c = tmoe.capacity(t, tc, capacity_factor)
    # the reference's formula, written out as moe.py:107-110 has it
    cj = int(max(8, -(-int(t * tc.moe_top_k * capacity_factor)
                      // tc.moe_experts)))
    assert c == min(cj + (-cj) % 8, max(t, 8))

    _, jids, _ = jmoe.router_topk(jnp.asarray(tp["router"]["w"]),
                                  jnp.asarray(x.reshape(t, -1)),
                                  tc.moe_top_k)
    e_flat = jids.reshape(-1)
    jorder = jnp.argsort(e_flat)
    jpos = jmoe._positions_in_runs(e_flat[jorder])
    order, sorted_e, pos, keep = tmoe.moe_dispatch(
        torch.as_tensor(np.array(jids)), c)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(sorted_e.numpy(),
                                  np.asarray(e_flat[jorder]))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jpos < c))

    jy, jm = jmoe.moe_ffn(_to_jax(tp), jnp.asarray(x), jc,
                          capacity_factor=capacity_factor)
    ty, tm = tmoe.moe_ffn(tp, torch.as_tensor(x), tc,
                          capacity_factor=capacity_factor)
    assert float(tm.dropped_frac) == float(jm.dropped_frac)
    if kind == "overflow":
        assert float(tm.dropped_frac) > 0.0
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    assert abs(float(tm.aux_loss) - float(jm.aux_loss)) <= 1e-5


def test_positions_in_runs_matches_reference():
    keys = np.sort(np.random.default_rng(0).integers(0, 9, 200))
    np.testing.assert_array_equal(
        tmoe._positions_in_runs(torch.as_tensor(keys)).numpy(),
        np.asarray(jmoe._positions_in_runs(jnp.asarray(keys))))


# ---------------------------------------------------------------------------
# caches, configs, weights
# ---------------------------------------------------------------------------

def test_mla_cache_is_compressed():
    """MLA's point: cache bytes per token ~ (lora + rope), far below
    GQA's 2 * Hkv * Dh (the reference's test, on the port's cache)."""
    cfg = t_smoke("deepseek-v3-671b")
    mla = tkv.init_mla_cache(cfg, 1, 8, device="cpu")
    mla_bytes = (mla.kv_latent.numel() * mla.kv_latent.element_size()
                 + mla.k_rope.numel() * mla.k_rope.element_size())
    gqa_equiv = 2 * cfg.n_layers * 8 * cfg.n_heads * cfg.resolved_head_dim * 2
    assert mla_bytes < gqa_equiv / 2
    assert mla.kv_latent.dtype == torch.bfloat16 and mla.length == 0


def test_decode_refuses_a_full_cache():
    tc = t_smoke("stablelm-3b")
    tp = _port_init(tc)
    cache = tkv.init_gqa_cache(tc, 1, 2, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    with torch.no_grad():
        for _ in range(2):
            _, cache = tkv.gqa_decode_step(tp, tc, tok, cache)
        with pytest.raises(ValueError, match="full"):
            tkv.gqa_decode_step(tp, tc, tok, cache)


def _as_data(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["dtype"] = jnp.dtype(d["dtype"]).name if not isinstance(
        d["dtype"], torch.dtype) else str(d["dtype"]).removeprefix("torch.")
    return d


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for j, t in ((j_config(arch), t_config(arch)),
                 (j_smoke(arch), t_smoke(arch))):
        assert _as_data(t) == _as_data(j)
        assert (t.resolved_head_dim, t.family) == (j.resolved_head_dim,
                                                   j.family)


def test_config_registry_and_shapes():
    assert set(ARCHS) <= set(tconfigs.list_archs())
    assert tconfigs.LM_ARCHS == ARCHS
    assert isinstance(t_config("madeye-approx"), tconfigs.DetectorConfig)
    assert t_smoke("madeye-approx") is tconfigs.MADEYE_APPROX_SMOKE
    assert ([dataclasses.asdict(s) for s in tconfigs.LM_SHAPES]
            == [dataclasses.asdict(s) for s in j_shapes.LM_SHAPES])
    cfg = t_config("stablelm-3b")
    assert tconfigs.shapes_for(cfg) == tconfigs.LM_SHAPES
    assert tconfigs.get_shape(cfg, "decode_32k").global_batch == 128
    with pytest.raises(KeyError):
        tconfigs.get_shape(cfg, "gen_1024")


def test_linear_init_std_and_lecun():
    """linear_init's LeCun default (std sqrt(1 / d_in), cut at +-2 std)
    and its std= form (the DiT family's zero init, std=0.0)."""
    w = tlayers.linear_init(np.random.default_rng(0), 400, 300,
                            dtype=torch.bfloat16)["w"]
    assert w.dtype == torch.bfloat16
    std = float(w.float().std())
    assert abs(std - 0.88 * (1 / 400) ** 0.5) < 0.05 * std
    assert float(w.float().abs().max()) <= 2.0 * (1 / 400) ** 0.5 * 1.01
    p = tlayers.linear_init(np.random.default_rng(0), 8, 4, std=0.0)
    assert not bool(p["w"].any()) and not bool(p["b"].any())


def test_lm_params_from_numpy_bf16_and_lists():
    """The reference's own bf16 MoE-MLA parameters (ml_dtypes bfloat16
    leaves, `dense_layers` a list, the router float32) carried across
    bit for bit; a float32 tree cast to the config's dtype but the
    router."""
    jc = j_smoke("deepseek-v3-671b")
    jp = jmlm.moe_lm_init(jax.random.PRNGKey(0), jc)
    tree = jax.tree.map(np.asarray, jp)
    assert tree["embed"]["table"].dtype.name == "bfloat16"
    tp = ttr.lm_params_from_numpy(tree, torch.bfloat16, device="cpu")
    assert isinstance(tp["dense_layers"], list)
    assert len(tp["dense_layers"]) == jc.first_dense_layers
    assert tp["moe_layers"]["moe"]["router"]["w"].dtype == torch.float32
    assert tp["moe_layers"]["moe"]["w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["dense_layers"][0]["attn"]["wkv_b"]["w"].float().numpy(),
        np.asarray(jp["dense_layers"][0]["attn"]["wkv_b"]["w"],
                   np.float32))
    assert tlayers.count_params(tp) == sum(
        x.size for x in jax.tree.leaves(jp))
    assert tlayers.param_bytes(tp) == sum(
        x.size * x.dtype.itemsize for x in jax.tree.leaves(jp))
    as32 = ttr.lm_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
        torch.bfloat16, device="cpu")
    assert as32["lm_head"]["w"].dtype == torch.bfloat16
    assert as32["moe_layers"]["moe"]["router"]["w"].dtype == torch.float32
    cast = tlayers.cast_floats(tp, torch.float32)
    assert cast["lm_head"]["w"].dtype == torch.float32


def test_lm_entry_points_default_to_the_card():
    """Without device="cpu" the LM entry points ask for the card, and
    raise where there is none (they never fall back)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = t_smoke("stablelm-3b")
    for make in (lambda: ttr.lm_init(np.random.default_rng(0), cfg),
                 lambda: tmlm.moe_lm_init(np.random.default_rng(0),
                                          t_smoke("kimi-k2-1t-a32b")),
                 lambda: tkv.init_gqa_cache(cfg, 1, 4),
                 lambda: tkv.init_mla_cache(t_smoke("deepseek-v3-671b"), 1,
                                            4),
                 lambda: ttr.lm_params_from_numpy(
                     {"w": np.zeros(2, np.float32)}, torch.float32)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
