"""The dense kernel on the card (`requires_cuda`: skipped without one; a
CUDA kernel has no CPU mode). Imports no JAX, so it runs where the card
is:

    PYTHONPATH=src python -m pytest -q tests/test_torch_dense_cuda.py

- the kernel against `dense_plain` (cuBLAS's float32 product, TF32 off)
  at every linear shape of the benchmark's cells — the ViT's d 192 /
  768 and Swin-B's stages (128-4,096) and patch merges — with and
  without bias and GELU, and at ragged M, N and K (x's rows not 16-byte
  aligned too): within 1e-4 absolute on outputs of order 1, the float32
  tolerance of the port's other split-TF32 kernels;
- a Swin-B detector forward under no_grad, at its published widths and
  24 crops (every linear then has >= layers.DENSE_MIN_ROWS rows and
  >= layers.DENSE_MIN_MACS multiply-adds), launches `dense` once per
  linear (147: 24 blocks x 6 and 3 patch merges), a 6-layer ViT
  detector at 150 crops its 36, each within 1e-4 of max(1, max |y|) of
  the same forward with the kernel turned off (cuBLAS, TF32 off);
- nothing launches where a gradient is needed, and the gradients are
  torch's; an input without rows launches nothing.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import DetectorConfig, VisionConfig
from repro_torch.configs.madeye_approx import MADEYE_APPROX
from repro_torch.kernels import _lib
from repro_torch.kernels.dense.ops import dense, dense_plain
from repro_torch.models import detector as det
from repro_torch.models import layers
from repro_torch.models.layers import full_float32

TOL = 1e-4

# (K, N) of every linear the five benchmark cells run
VIT = [(192, 192), (192, 768), (768, 192)]
SWIN = [(128, 128), (128, 512), (512, 128), (256, 256), (256, 1024),
        (1024, 256), (512, 512), (512, 2048), (2048, 512), (1024, 1024),
        (1024, 4096), (4096, 1024), (512, 256), (1024, 512), (2048, 1024)]
# (M, K, N): ragged tails in every dimension, one row, one column
RAGGED = [(1, 1, 1), (129, 13, 5), (300, 100, 70), (77, 4097, 257),
          (5, 3, 1000), (1000, 20, 200), (130, 64, 64)]
VARIANTS = [(False, None), (True, None), (True, "gelu")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda")


def _operands(m, k, n, device, seed=0):
    g = np.random.default_rng(seed + m + k + n)
    x = g.normal(0, 1, (m, k)).astype(np.float32)
    w = (g.normal(0, 1, (k, n)) / np.sqrt(k)).astype(np.float32)
    b = g.normal(0, 0.1, n).astype(np.float32)
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(w, device=device),
            torch.as_tensor(b, device=device))


def _check(x, w, b, act):
    _lib.reset_launch_counts()
    got = dense(x, w, b, act=act)
    assert _lib.launch_counts()["dense"] == 1
    with full_float32():
        want = dense_plain(x, w, b, act)
    torch.cuda.synchronize()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("variant", VARIANTS,
                         ids=["plain", "bias", "bias-gelu"])
@pytest.mark.parametrize("kn", VIT + SWIN, ids=[f"{k}x{n}" for k, n in
                                                 VIT + SWIN])
def test_dense_at_the_cells_shapes(cuda, kn, variant):
    x, w, b = _operands(1000, *kn, cuda)
    with_bias, act = variant
    _check(x, w, b if with_bias else None, act)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("variant", VARIANTS,
                         ids=["plain", "bias", "bias-gelu"])
@pytest.mark.parametrize("mkn", RAGGED, ids=[str(s) for s in RAGGED])
def test_dense_ragged(cuda, mkn, variant):
    x, w, b = _operands(*mkn, cuda)
    with_bias, act = variant
    _check(x, w, b if with_bias else None, act)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("k", [12, 13])
def test_dense_rows_off_16_bytes(cuda, k):
    """x a view one float into its storage: rows stream in 4-byte
    copies; 3-d x flattens its leading dims."""
    x, w, b = _operands(2 * 3 * 50, k, 48, cuda)
    xv = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(2, 150, k)
    assert xv.data_ptr() % 16 != 0
    _check(xv, w, b, "gelu")


@pytest.mark.requires_cuda
def test_empty_input_launches_nothing(cuda):
    """No rows: an empty result without a launch, so a launch count
    always means the kernel ran."""
    x, w, b = _operands(4, 24, 40, cuda)
    _lib.reset_launch_counts()
    out = dense(x[:0], w, b, act="gelu")
    assert out.shape == (0, 40) and _lib.launch_counts()["dense"] == 0


SWIN_B = DetectorConfig(
    name="swin-b", img_res=224, patch=4, max_boxes=8, fpn_dim=128,
    swin=VisionConfig(name="swin-b", img_res=224, patch=4, n_layers=24,
                      d_model=128, n_heads=4, d_ff=512, swin=True, window=7,
                      depths=(2, 2, 18, 2), dims=(128, 256, 512, 1024),
                      dtype=torch.float32))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cfg,crops,tokens,launches", [
    (SWIN_B, 24, 3136, 147), (MADEYE_APPROX, 150, 196, 36)],
    ids=["swin-b", "madeye-approx"])
def test_detector_forward_launches_once_per_linear(cuda, cfg, crops, tokens,
                                                   launches, monkeypatch):
    params = det.params_from_numpy(
        det.detector_init(np.random.default_rng(5), cfg, "cpu"), cuda)
    d = cfg.swin.dims[0] if cfg.swin is not None else cfg.d_model
    tok = torch.as_tensor(np.random.default_rng(6).normal(
        0, 1, (crops, tokens, d)).astype(np.float32), device=cuda)
    with full_float32(), torch.no_grad():
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        got = det.detector_neck_feats_tokens(params, cfg, tok)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _lib.launch_counts().items() if v}
        monkeypatch.setattr(layers, "_dense_engages", lambda *a: False)
        _lib.reset_launch_counts()
        want = det.detector_neck_feats_tokens(params, cfg, tok)
        torch.cuda.synchronize()
        assert _lib.launch_counts()["dense"] == 0
    assert counts.pop("dense") == launches
    assert set(counts) <= {"flash_attention"}
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= TOL * scale


@pytest.mark.requires_cuda
def test_nothing_launches_where_gradients_flow(cuda):
    # every product large enough to launch without its gradient
    g = torch.Generator().manual_seed(7)
    p = {k: v.to(cuda) for k, v in layers.linear_init(g, 1024, 1024).items()}
    pm = {n: {k: v.to(cuda) for k, v in q.items()}
          for n, q in layers.mlp_init(g, 1024, 2048).items()}
    x = torch.randn(2, 512, 1024, generator=g).to(cuda).requires_grad_()
    w = p["w"].clone().requires_grad_()
    _lib.reset_launch_counts()
    with full_float32():
        y = layers.linear({"w": w, "b": p["b"]}, x, act="gelu")
        z = layers.mlp(pm, x)
        (y.sum() + z.sum()).backward()
        gw = torch.func.grad(lambda ww: layers.linear(
            {"w": ww, "b": p["b"]}, x.detach()).sum())(p["w"])
        with torch.no_grad():
            rows = torch.vmap(lambda r: layers.linear(p, r))(x.detach())
        # torch's own gradient of the same product
        want = torch.func.grad(lambda ww: (x.detach() @ ww + p["b"]).sum())(
            p["w"])
    torch.cuda.synchronize()
    assert _lib.launch_counts()["dense"] == 0
    assert x.grad is not None and w.grad is not None
    torch.testing.assert_close(gw, want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        _lib.reset_launch_counts()
        again = layers.linear(p, x.detach())
        assert _lib.launch_counts()["dense"] == 1
    torch.testing.assert_close(rows, again, rtol=0, atol=TOL)
