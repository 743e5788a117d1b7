"""The LM half of the model zoo on the card (`requires_cuda`: skipped
without one; the flash kernel has no CPU mode). Imports no JAX, so it
runs where the card is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_lm_cuda.py

At the four SMOKE configs (weights drawn by numpy, the same under any
PyTorch), float32: impl="flash" inside `lm_forward` and
`moe_lm_forward` launches flash_attention once per layer and nothing
else, and agrees with impl="xla" within 1e-4 (the kernel's split-TF32
products and online softmax against float32 sums in another order,
3e-5 on attention outputs of order 1, through two layers to logits of
order 3); prefill and decode launch no kernel; the card's logits agree
with the CPU's within 1e-4 (decode from an empty float32 cache). In
bf16 the card's forward, prefill and decode logits agree with the CPU's
within 2e-2, and the MoE router picks the same experts but at a near tie
(the top-k boundary's gap under 1e-6), with the same dispatch plan.

At full width (weights from seeded CUDA generators, compared only with
other runs on the card):

- stablelm-3b, full depth, float32, 4 requests of 2048 prompt + 16
  continuation tokens: the forward with impl="flash" launches
  flash_attention once per layer and dense once per linear (7 a layer
  and the head), with "xla" and the prefill dense only, a decode step
  (4 rows, below layers.DENSE_MIN_ROWS) nothing; flash vs xla and
  prefill vs forward within the flash kernel's float32 tolerance (3e-5)
  scaled to the logits' largest magnitude, each decode step vs the
  forward's position within 2e-2 (the bf16 cache; the reference's own
  tolerance for that comparison), argmax equal wherever the top-2
  margin is clear;
- deepseek-v3 at full width, depth cut to its 3 dense and 1 MoE layer
  (the 61-layer model does not fit one card), bf16, 2 x 512 tokens: the
  forward with flash launches it once per layer (MLA heads of 192, v
  padded), nothing else launches; flash vs xla with room in every
  expert, mla_prefill against the forward over the same prompt as
  configured, and 8 mla_decode_steps against the roomy forward, each on
  the tokens the MoE layer treated alike in both runs (the same experts,
  the same of them kept), within 0.25 (a handful of bf16 ulps of logits
  of magnitude 2-4, at most ~16) and argmax equal at margins above it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (  # noqa: E402
    LM_ARCHS,
    get_config,
    get_smoke_config,
)
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import layer_params  # noqa: E402
from repro_torch.train.optim import tree_map  # noqa: E402
from repro_torch.models.moe_lm import moe_lm_forward, moe_lm_init  # noqa: E402
from repro_torch.models.transformer import lm_forward, lm_init  # noqa: E402

B, PROMPT, TOTAL = 2, 8, 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


def _model(arch: str):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    moe = cfg.moe_experts is not None
    params = (moe_lm_init if moe else lm_init)(np.random.default_rng(0),
                                               cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, TOTAL)))

    def forward(p, t, impl):
        if moe:
            return moe_lm_forward(p, cfg, t, impl=impl)[0]
        return lm_forward(p, cfg, t, impl=impl)

    return cfg, params, toks, forward


def _counted(fn):
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in _lib.launch_counts().items() if v}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_flash_inside_the_lm_matches_xla(cuda, arch):
    cfg, params, toks, forward = _model(arch)
    p, t = tree_map(lambda x: x.to(cuda), params), toks.to(cuda)
    with torch.no_grad():
        flash, counts = _counted(lambda: forward(p, t, "flash"))
        assert counts == {"flash_attention": cfg.n_layers}
        xla, counts = _counted(lambda: forward(p, t, "xla"))
        assert counts == {}
        cpu = forward(params, toks, "xla")
    assert float((flash - xla).abs().max()) <= 1e-4
    assert float((xla.cpu() - cpu).abs().max()) <= 1e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_decode_launch_no_kernel(cuda, arch):
    """Prefill and decode launch no kernel on the card; prefill's logits
    and decode's from an empty float32 cache agree with the CPU's
    within 1e-4 (the bf16 cache the prefill fills may round a k/v
    element to the neighbouring bf16 value on one device and not the
    other, which moves later steps by ~1e-4)."""
    cfg, params, toks, forward = _model(arch)
    p, t = tree_map(lambda x: x.to(cuda), params), toks.to(cuda)
    if cfg.mla:
        pre, dec = kvcache.mla_prefill, kvcache.mla_decode_step
        init = kvcache.init_mla_cache
    elif cfg.moe_experts is not None:
        pre, dec = kvcache.moe_gqa_prefill, kvcache.moe_gqa_decode_step
        init = kvcache.init_gqa_cache
    else:
        pre, dec = kvcache.gqa_prefill, kvcache.gqa_decode_step
        init = kvcache.init_gqa_cache
    with torch.no_grad():
        (logits, cache), counts = _counted(
            lambda: pre(p, cfg, t[:, :PROMPT], max_seq=TOTAL))
        assert counts == {}
        cpu_logits, _ = pre(params, cfg, toks[:, :PROMPT], max_seq=TOTAL)
        assert float((logits.cpu() - cpu_logits).abs().max()) <= 1e-4
        for i in range(PROMPT, TOTAL):
            (logits, cache), counts = _counted(
                lambda: dec(p, cfg, t[:, i:i + 1], cache))
            assert counts == {}
            assert bool(torch.isfinite(logits).all())
        assert cache.length == TOTAL
        gpu_cache = init(cfg, B, TOTAL, dtype=torch.float32, device=cuda)
        cpu_cache = init(cfg, B, TOTAL, dtype=torch.float32, device="cpu")
        for i in range(TOTAL):
            logits, gpu_cache = dec(p, cfg, t[:, i:i + 1], gpu_cache)
            cpu_logits, cpu_cache = dec(params, cfg, toks[:, i:i + 1],
                                        cpu_cache)
            assert float((logits.cpu() - cpu_logits).abs().max()) <= 1e-4


def _cache_fns(cfg):
    """(prefill, decode step, empty cache) of an LM config."""
    if cfg.mla:
        return kvcache.mla_prefill, kvcache.mla_decode_step, \
            kvcache.init_mla_cache
    if cfg.moe_experts is not None:
        return kvcache.moe_gqa_prefill, kvcache.moe_gqa_decode_step, \
            kvcache.init_gqa_cache
    return kvcache.gqa_prefill, kvcache.gqa_decode_step, \
        kvcache.init_gqa_cache


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_bf16_smoke_card_matches_cpu(cuda, arch, monkeypatch):
    """bf16 forward, prefill and decode (from the prefill's cache)
    logits, card vs CPU, within 2e-2; the bf16 products reduce in float32
    on the card too."""
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.bfloat16)
    init = moe_lm_init if cfg.moe_experts is not None else lm_init
    params = init(np.random.default_rng(0), cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, TOTAL)))
    pre, dec, _ = _cache_fns(cfg)

    def run(p, t):
        if cfg.moe_experts is not None:
            out = [moe_lm_forward(p, cfg, t)[0]]
        else:
            out = [lm_forward(p, cfg, t)]
        logits, cache = pre(p, cfg, t[:, :PROMPT], max_seq=TOTAL)
        out.append(logits)
        for i in range(PROMPT, TOTAL):
            logits, cache = dec(p, cfg, t[:, i:i + 1], cache)
            out.append(logits)
        return out

    with torch.no_grad():
        want = run(params, toks)
        got = run(tree_map(lambda x: x.to(cuda), params), toks.to(cuda))
    for g, w in zip(got, want):
        assert float((g.cpu().float() - w.float()).abs().max()) <= 2e-2


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", [a for a in LM_ARCHS if get_smoke_config(
    a).moe_experts is not None])
def test_router_and_dispatch_card_matches_cpu(cuda, arch):
    """The first MoE layer's router on one float32 input [32, D], card vs
    CPU: the same experts but at a near tie (the top-k boundary's gap
    under 1e-6); then the dispatch plan of the same ids equal."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=torch.float32)
    params = moe_lm_init(np.random.default_rng(0), cfg, device="cpu")
    lp = layer_params(params["moe_layers"], 0)["moe"]
    x = torch.as_tensor(np.random.default_rng(2).normal(
        0, 1, (32, cfg.d_model)).astype(np.float32))
    k = cfg.moe_top_k
    _, ids_c, probs = moe.router_topk(lp["router"]["w"], x, k)
    _, ids_g, _ = moe.router_topk(lp["router"]["w"].to(cuda), x.to(cuda), k)
    srt = probs.sort(-1, descending=True).values
    gap = (srt[:, :k] - srt[:, 1:k + 1]).min(-1).values
    differ = (ids_g.cpu() != ids_c).any(-1)
    assert not bool((differ & (gap >= 1e-6)).any())
    c = moe.capacity(x.shape[0], cfg, 0.5)
    for a, b in zip(moe.moe_dispatch(ids_c, c),
                    moe.moe_dispatch(ids_c.to(cuda), c)):
        assert torch.equal(a, b.cpu())


def _clear_flips(got, want, margin: float) -> int:
    """Positions where want's top-2 logits are more than `margin` apart
    and the argmax differs."""
    top2 = want.float().topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > margin
    return int((sure & (got.float().argmax(-1)
                        != want.float().argmax(-1))).sum())


@pytest.mark.requires_cuda
def test_full_width_stablelm_float32(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("stablelm-3b"), dtype=torch.float32)
    n, p = 2048 + 16, 2048
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = lm_init(gen, cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab, (4, n), generator=gen, device=cuda)
    dense = {"dense": 7 * cfg.n_layers + 1}
    with torch.no_grad():
        fl, counts = _counted(lambda: lm_forward(params, cfg, toks,
                                                 impl="flash"))
        assert counts == {"flash_attention": cfg.n_layers} | dense
        xl, counts = _counted(lambda: lm_forward(params, cfg, toks,
                                                 impl="xla"))
        assert counts == dense
        tol = 3e-5 * float(xl.abs().max())
        assert float((fl - xl).abs().max()) <= tol
        assert _clear_flips(fl, xl, tol) == 0
        del fl
        (pl, cache), counts = _counted(lambda: kvcache.gqa_prefill(
            params, cfg, toks[:, :p], max_seq=n))
        assert counts == dense
        assert float((pl - xl[:, :p]).abs().max()) <= tol
        del pl
        for i in range(p, n):
            (dl, cache), counts = _counted(lambda: kvcache.gqa_decode_step(
                params, cfg, toks[:, i:i + 1], cache))
            assert counts == {}
            assert float((dl[:, 0] - xl[:, i]).abs().max()) <= 2e-2
            assert _clear_flips(dl[:, 0], xl[:, i], 2e-2) == 0


MOE_BF16_ABS = 0.25


def _treated(call, capacity_factor: float) -> torch.Tensor:
    """How one recorded moe_ffn call treated each token, recomputed from
    its input: its (expert, kept) pairs, sorted [T, K] (2 * expert +
    kept)."""
    p, x, cfg = call
    ids = moe.router_topk(p["router"]["w"], x.reshape(-1, x.shape[-1]),
                          cfg.moe_top_k)[1]
    order, _, _, keep = moe.moe_dispatch(
        ids, moe.capacity(ids.shape[0], cfg, capacity_factor))
    kept = torch.empty_like(keep)
    kept[order] = keep
    return (2 * ids + kept.reshape(ids.shape)).sort(-1).values


def _bf16_close(got, want, alike) -> None:
    """got within MOE_BF16_ABS of want over the tokens treated alike
    ([B, S] mask), the argmax equal where want's margin exceeds it."""
    g, w = got.float()[alike], want.float()[alike]
    assert g.numel() > 0
    assert float((g - w).abs().max()) <= MOE_BF16_ABS
    assert _clear_flips(g, w, MOE_BF16_ABS) == 0


@pytest.mark.requires_cuda
def test_full_width_deepseek_v3_bf16(cuda, monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul,
                        "allow_bf16_reduced_precision_reduction", False)
    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=4)
    b, n, p = 2, 512, 512 - 8
    roomy = cfg.moe_experts / cfg.moe_top_k   # room for every assignment
    gen = torch.Generator(device=cuda).manual_seed(2)
    params = moe_lm_init(gen, cfg, device=cuda)
    toks = torch.randint(0, cfg.vocab, (b, n), generator=gen, device=cuda)
    calls = []
    ffn = moe.moe_ffn

    def recorded(lp, x, c, **kwargs):
        calls.append((lp, x.clone(), c))
        return ffn(lp, x, c, **kwargs)

    monkeypatch.setattr(moe, "moe_ffn", recorded)

    def run(fn):
        calls.clear()
        out, counts = _counted(fn)
        return out, counts, calls[0]

    with torch.no_grad():
        (cl, _), counts, c_call = run(lambda: moe_lm_forward(
            params, cfg, toks[:, :p]))
        assert counts == {}
        (fl, _), counts, f_call = run(lambda: moe_lm_forward(
            params, cfg, toks, impl="flash", capacity_factor=roomy))
        assert counts == {"flash_attention": cfg.n_layers}
        (xl, _), counts, x_call = run(lambda: moe_lm_forward(
            params, cfg, toks, capacity_factor=roomy))
        assert counts == {}
        tx = _treated(x_call, roomy)
        _bf16_close(fl, xl, (_treated(f_call, roomy) == tx).all(-1)
                    .reshape(b, n))
        del fl
        (pl, cache), counts, p_call = run(lambda: kvcache.mla_prefill(
            params, cfg, toks[:, :p], max_seq=n))
        assert counts == {}
        _bf16_close(pl, cl, (_treated(p_call, 1.25) == _treated(
            c_call, 1.25)).all(-1).reshape(b, p))
        del pl
        dec, alike = [], []
        tx = tx.reshape(b, n, -1)
        for i in range(p, n):
            (dl, cache), counts, d_call = run(lambda: kvcache.mla_decode_step(
                params, cfg, toks[:, i:i + 1], cache))
            assert counts == {}
            dec.append(dl[:, 0])
            alike.append((_treated(d_call, 1.25) == tx[:, i]).all(-1))
        _bf16_close(torch.stack(dec, 1), xl[:, p:], torch.stack(alike, 1))
