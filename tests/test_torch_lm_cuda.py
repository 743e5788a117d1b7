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
with the CPU's within 1e-4 (decode from an empty float32 cache).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import LM_ARCHS, get_smoke_config  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.models import kvcache  # noqa: E402
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
