"""Why the port's tensor-core kernels split float32 into two TF32 halves.

crop_patchify and flash_attention run their float32 products on the
H100's tensor cores in TF32, which keeps 10 of float32's 23 mantissa
bits. A numpy emulation of the card's rounding (cvt.rna.tf32.f32:
nearest, ties away from zero) shows, at the two kernels' real depths,
that one TF32 product (1xTF32) breaks the tolerances tools/kernel_table.py
and the card-only tests hold them to (1e-4 on patch tokens, 3e-5 on float32
attention), and that the split product hi.hi' + hi.lo' + lo.hi'
(3xTF32, csrc/wgmma.cuh) stays far inside them. Products are summed in
float64 here, so the figures isolate the rounding of the operands.

Also pins the wrapper's weight split (crop_patchify.ops.tf32_split,
tf32_split_weights) against the emulation and against the layout the
kernel reads, and that the kernels' build is named by every source and
header. Runs on the CPU (`pytest -s` prints the errors).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.crop_patchify.ops import (
    K_CHUNK,
    n_tile,
    tf32_round,
    tf32_split,
    tf32_split_weights,
)

PATCH_TOL = 1e-4     # crop_patchify tokens (kernel table, card tests)
ATTN_TOL = 3e-5      # float32 flash_attention outputs


def rna_tf32(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on finite float32 values."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    out = (bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return out.view(np.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(np.float32(x) - hi)


def matmul_tf32(a, b, n_terms: int):
    """a @ b with operands rounded as the kernels round them: 1 = plain
    TF32, 3 = split TF32; sums in float64."""
    ah, al = (t.astype(np.float64) for t in split(a))
    bh, bl = (t.astype(np.float64) for t in split(b))
    if n_terms == 1:
        return ah @ bh
    return ah @ bh + ah @ bl + al @ bh


def test_rna_rounding_reference_points():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                  # TF32 spacing at 1
    x = np.array([one + ulp / 2, one + ulp / 2 - 2 ** -23, -(one + ulp / 2),
                  one + 1.5 * ulp, 3.0e-3, -7.25], np.float32)
    got = rna_tf32(x)
    want = np.array([one + ulp, one, -(one + ulp), one + 2 * ulp,
                     got[4], -7.25], np.float32)
    np.testing.assert_array_equal(got, want)      # ties away from zero
    assert (got.view(np.uint32) & 0x1FFF == 0).all()
    assert abs(got[4] - 3.0e-3) <= 2.0 ** -11 * 3.0e-3


def test_split_tf32_keeps_crop_patchify_inside_tolerance():
    """The main path's token product: pixels in [0, 1] against patch-embed
    weights N(0, 1/768), depth 768 (16 x 16 x 3), 192 features."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0, 1, (1000, 768)).astype(np.float32)
    w = rng.normal(0, 1 / np.sqrt(768), (768, 192)).astype(np.float32)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    err1 = np.abs(matmul_tf32(a, w, 1) - ref).max()
    err3 = np.abs(matmul_tf32(a, w, 3) - ref).max()
    print(f"crop_patchify product: 1xTF32 {err1:.3e}, 3xTF32 {err3:.3e}")
    assert err1 > PATCH_TOL          # plain TF32 breaks the tolerance
    assert err3 < PATCH_TOL / 100    # split TF32 keeps float32-class bits


def attention_tf32(q, k, v, n_terms: int):
    """softmax(q k^T / sqrt(D)) v per head with both products rounded as
    the kernel rounds them; softmax in float64."""
    d = q.shape[-1]
    s = np.stack([matmul_tf32(qi, ki.T, n_terms) for qi, ki in zip(q, k)])
    s = s / np.sqrt(d)
    p = np.exp(s - s.max(-1, keepdims=True))
    l = p.sum(-1, keepdims=True)
    p32 = p.astype(np.float32)                   # P as the kernel holds it
    o = np.stack([matmul_tf32(pi, vi, n_terms) for pi, vi in zip(p32, v)])
    return o / l


def test_split_tf32_keeps_vit_attention_inside_tolerance():
    """The ViT layer: D = 32 logits, 197 keys in P.V, N(0, 1) inputs."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(0, 1, (24, 197, 32)).astype(np.float32)
               for _ in range(3))
    s = np.einsum("hqd,hkd->hqk", q.astype(np.float64), k) / np.sqrt(32)
    p = np.exp(s - s.max(-1, keepdims=True))
    ref = np.einsum("hqk,hkd->hqd", p / p.sum(-1, keepdims=True), v)
    err1 = np.abs(attention_tf32(q, k, v, 1) - ref).max()
    err3 = np.abs(attention_tf32(q, k, v, 3) - ref).max()
    print(f"ViT attention: 1xTF32 {err1:.3e}, 3xTF32 {err3:.3e}")
    assert err1 > ATTN_TOL
    assert err3 < ATTN_TOL / 10


@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0])
def test_wrapper_split_matches_emulation(scale):
    gen = torch.Generator().manual_seed(2)
    w = torch.randn(768, 192, generator=gen) * scale
    hi, lo = tf32_split(w)
    np.testing.assert_array_equal(tf32_round(w).numpy(),
                                  rna_tf32(w.numpy()))
    np.testing.assert_array_equal(hi.numpy(), rna_tf32(w.numpy()))
    np.testing.assert_array_equal(lo.numpy(), split(w.numpy())[1])
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    rel = ((hi.double() + lo.double() - w.double()).abs()
           / w.double().abs()).max()
    assert float(rel) <= 2.0 ** -22


@pytest.mark.parametrize("depth,d", [(768, 192), (768, 48), (300, 200)])
def test_split_weights_layout_is_what_the_kernel_reads(depth, d):
    """Element (n, k) of half `hl` sits where csrc/crop_patchify.cu's
    descriptors find it: tile n // NT, chunk k // K_CHUNK, then 8 x 4
    core matrices with K fastest; zero past D and depth."""
    gen = torch.Generator().manual_seed(depth + d)
    w = torch.randn(depth, d, generator=gen)
    flat = tf32_split_weights(w).reshape(-1)
    nt = n_tile(d)
    n_kc = -(-depth // K_CHUNK)
    halves = tf32_split(w)
    n = torch.arange(-(-d // nt) * nt)[:, None]
    k = torch.arange(n_kc * K_CHUNK)[None, :]
    nl, kk = n % nt, k % K_CHUNK
    for hl in (0, 1):
        idx = ((((n // nt) * n_kc + k // K_CHUNK) * 2 + hl) * nt * K_CHUNK
               + ((nl // 8) * (K_CHUNK // 4) + kk // 4) * 32
               + (nl % 8) * 4 + kk % 4)
        got = flat[idx]
        want = torch.zeros_like(got)
        want[:d, :depth] = halves[hl].t()
        assert torch.equal(got, want)


def test_library_hash_covers_every_source_and_header(tmp_path, monkeypatch):
    """An edit to any csrc/*.cu or *.cuh (wgmma.cuh included) names a new
    build, so a stale library is never loaded."""
    from repro_torch.kernels import _lib

    for path in _lib.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_lib, "CSRC", tmp_path)
    names = sorted(p.name for p in tmp_path.glob("*.cu*"))
    assert "wgmma.cuh" in names and "common.cuh" in names
    seen = {_lib.library_path()}
    for name in names:
        f = tmp_path / name
        f.write_bytes(f.read_bytes() + b"\n// edited\n")
        seen.add(_lib.library_path())
    assert len(seen) == len(names) + 1
