"""The dense kernel's contract on the CPU (kernels/dense, csrc/dense.cu).

- `dense_plain` is the models' own linear (x @ w + b, then layers.gelu),
  and `layers.linear` / `layers.mlp` on the CPU are unchanged by the
  kernel's `act` argument;
- the wrapper refuses what the kernel does not take before anything
  reaches the library, and CPU, meta, FakeTensor, DTensor and
  gradient-requiring inputs to `layers.linear` never reach it;
- the engagement rule: plain float32 CUDA tensors whose result needs no
  gradient, in products of at least layers.DENSE_MIN_ROWS rows and
  layers.DENSE_MIN_MACS multiply-adds (each threshold tried on both
  sides; an LM decode step's few rows keep torch's product);
- a numpy-free emulation of the card's TF32 rounding (summed in float64,
  as tests/test_torch_tf32_split.py does) at Swin-B's stage-3 and the
  ViT's shapes: the kernel's split product hi.hi' + hi.lo' + lo.hi'
  stays float32-class, one TF32 product does not;
- a model of the pre-pass's writes puts every element of both TF32
  halves where the product's wgmma descriptors read it.

The kernel itself runs on the card: tests/test_torch_dense_cuda.py.
"""
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch import mesh as tmesh
from repro_torch.kernels import _lib
from repro_torch.kernels.crop_patchify.ops import tf32_split
from repro_torch.kernels.dense import ops
from repro_torch.models import layers
from repro_torch.train.optim import tree_map

DETECTOR_TOL = 1e-4   # the benchmark's detector limit and the card tests'

# (M, K, N): a Swin-B stage-3 fc1 slice, the ViT's wq and MLP, a ragged
# shape with odd K and N
SHAPES = [(50, 512, 2048), (40, 192, 192), (30, 192, 768), (30, 768, 192),
          (7, 13, 5)]


@pytest.fixture
def no_launch(monkeypatch):
    """Anything that reaches the kernel library fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("reached the kernel library")
    monkeypatch.setattr(_lib, "launch", refuse)
    monkeypatch.setattr(_lib, "library", refuse)


def _operands(m, k, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(m, k, generator=g),
            torch.randn(k, n, generator=g) / k ** 0.5,
            torch.randn(n, generator=g) * 0.1)


@pytest.mark.parametrize("act", [None, "gelu"])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plain_is_the_models_linear(no_launch, shape, with_bias, act):
    x, w, b = _operands(*shape)
    b = b if with_bias else None
    y = x @ w if b is None else x @ w + b
    want = layers.gelu(y) if act else y
    assert torch.equal(ops.dense_plain(x, w, b, act), want)
    assert torch.equal(ops.dense(x, w, b, act=act), want)
    p = {"w": w} if b is None else {"w": w, "b": b}
    assert torch.equal(layers.linear(p, x, act=act), want)


def test_mlp_on_cpu_is_down_gelu_up(no_launch):
    g = torch.Generator().manual_seed(1)
    p = layers.mlp_init(g, 24, 96)
    for name in ("up", "down"):
        p[name]["b"] = torch.randn(p[name]["b"].shape, generator=g)
    x = torch.randn(2, 5, 24, generator=g)
    h = layers.gelu(x @ p["up"]["w"] + p["up"]["b"])
    assert torch.equal(layers.mlp(p, x), h @ p["down"]["w"] + p["down"]["b"])
    pg = layers.mlp_init(g, 24, 96, gated=True)
    hg = layers.silu(x @ pg["gate"]["w"] + pg["gate"]["b"]) * (
        x @ pg["up"]["w"] + pg["up"]["b"])
    assert torch.equal(layers.mlp(pg, x),
                       hg @ pg["down"]["w"] + pg["down"]["b"])


def _bad_inputs():
    """(label, x, w, b, act) the wrapper must refuse, as CUDA tensors
    under FakeTensorMode (no card needed: it refuses before it would
    touch a pointer)."""
    cuda = "cuda"
    x = torch.empty(6, 8, device=cuda)
    w = torch.empty(8, 4, device=cuda)
    b = torch.empty(4, device=cuda)
    return [
        ("float64 x", x.double(), w, b, None),
        ("bfloat16 w", x, w.bfloat16(), b, None),
        ("float16 bias", x, w, b.half(), None),
        ("w on the CPU", x, torch.empty(8, 4, device="cpu"), b, None),
        ("transposed x", torch.empty(8, 6, device=cuda).t(), w, b, None),
        ("transposed w", x, torch.empty(4, 8, device=cuda).t(), b, None),
        ("K mismatch", torch.empty(6, 9, device=cuda), w, b, None),
        ("3-d w", x, torch.empty(8, 4, 1, device=cuda), b, None),
        ("bias length", x, w, torch.empty(5, device=cuda), None),
        ("no columns", x, torch.empty(8, 0, device=cuda), None, None),
        ("unknown act", x, w, b, "relu"),
    ]


N_BAD = 11


@pytest.mark.parametrize("case", range(N_BAD))
def test_wrapper_refuses_before_any_launch(no_launch, case):
    with FakeTensorMode(allow_non_fake_inputs=True):
        bad = _bad_inputs()
        assert len(bad) == N_BAD
        label, x, w, b, act = bad[case]
        with pytest.raises((TypeError, ValueError)):
            ops.dense(x, w, b, act=act)


def test_meta_tensors_are_refused(no_launch):
    x, w = torch.empty(4, 8, device="meta"), torch.empty(8, 3,
                                                          device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.dense(x, w)


def _linear_and_mlp(x, place=lambda t: t):
    """layers.linear (with its GELU) and layers.mlp on x, on weights
    drawn from one seed and handed to `place`."""
    g = torch.Generator().manual_seed(2)
    p = tree_map(place, layers.linear_init(g, x.shape[-1], 12))
    pm = tree_map(place, layers.mlp_init(g, x.shape[-1], 16))
    return layers.linear(p, x, act="gelu"), layers.mlp(pm, x)


@pytest.mark.parametrize("kind", ["cpu", "cpu-grad", "meta", "fake-cuda"])
def test_linear_keeps_the_plain_path(no_launch, kind):
    if kind.startswith("fake"):
        # rows and multiply-adds enough that only the fake mode refuses
        with FakeTensorMode():
            x = torch.empty(128, 1024, 1024, device="cuda")
            y, z = _linear_and_mlp(x, lambda t: torch.empty(
                t.shape, device="cuda"))
        assert y.shape == (128, 1024, 12) and z.shape == x.shape
        return
    device = "meta" if kind == "meta" else "cpu"
    x = torch.randn(3, 5, 8, device=device,
                    requires_grad=kind.endswith("grad"))
    y, z = _linear_and_mlp(x, lambda t: t.to(device))
    assert y.shape == (3, 5, 12) and z.shape == (3, 5, 8)
    if kind == "cpu-grad":
        (y.sum() + z.sum()).backward()
        assert x.grad is not None and x.grad.shape == x.shape


@pytest.fixture
def one_rank():
    """A one-rank gloo group made by make_debug_mesh, torn down after."""
    assert not dist.is_initialized()
    yield tmesh.make_debug_mesh(device="cpu")
    dist.destroy_process_group()


def test_linear_on_dtensors_keeps_the_plain_path(no_launch, one_rank):
    mesh = one_rank
    x = torch.randn(4, 5, 8)
    dx = DTensor.from_local(x, mesh, [Shard(0), Replicate()],
                            run_check=False)
    y, z = _linear_and_mlp(dx, lambda t: DTensor.from_local(
        t, mesh, [Replicate(), Replicate()], run_check=False))
    want_y, want_z = _linear_and_mlp(x)
    assert isinstance(y, DTensor) and isinstance(z, DTensor)
    torch.testing.assert_close(y.full_tensor(), want_y, rtol=0, atol=1e-6)
    torch.testing.assert_close(z.full_tensor(), want_z, rtol=0, atol=1e-6)


def test_engagement_rule(monkeypatch):
    """Which operands would launch, with FakeTensorMode's own refusal
    (shape_only) taken out, so the other clauses show."""
    monkeypatch.setattr(layers, "shape_only", lambda device=None: False)
    with FakeTensorMode():
        x = torch.empty(layers.DENSE_MIN_ROWS, 1024, device="cuda")
        w = torch.empty(1024, 1024, device="cuda")
        b = torch.empty(1024, device="cuda")
        engages = layers._dense_engages
        assert engages(x, w, b) and engages(x, w, None)
        assert not engages(x.bfloat16(), w.bfloat16(), b.bfloat16())
        assert not engages(x, w.double(), b)
        assert not engages(x.cpu(), w.cpu(), b.cpu())
        wg = torch.empty(1024, 1024, device="cuda", requires_grad=True)
        assert not engages(x, wg, b)
        assert not engages(x, w, torch.empty(1024, device="cuda",
                                             requires_grad=True))
        with torch.no_grad():
            assert engages(x, wg, b)
        with torch.inference_mode():
            assert engages(x, w, b)


# (x's shape, w's shape, engages): each threshold on both sides, rows
# counted over x's leading dims, stablelm-3b's decode step and prefill
SIZES = [((1023, 1024), (1024, 1024), False),
         ((1024, 1024), (1024, 1024), True),
         ((2, 511, 1024), (1024, 1024), False),
         ((2, 512, 1024), (1024, 1024), True),
         ((4096, 512), (512, 511), False),
         ((4096, 512), (512, 512), True),
         ((4, 1, 2560), (2560, 6912), False),
         ((4, 2048, 2560), (2560, 6912), True)]


@pytest.mark.parametrize("xs,ws,want", SIZES,
                         ids=[f"{x}@{w}" for x, w, _ in SIZES])
def test_engagement_needs_rows_and_work(monkeypatch, xs, ws, want):
    """At least DENSE_MIN_ROWS rows and DENSE_MIN_MACS multiply-adds:
    below either, torch's product is the faster (layers.py)."""
    assert layers.DENSE_MIN_ROWS == 1024 and layers.DENSE_MIN_MACS == 2 ** 30
    monkeypatch.setattr(layers, "shape_only", lambda device=None: False)
    with FakeTensorMode():
        x = torch.empty(xs, device="cuda")
        w = torch.empty(ws, device="cuda")
        b = torch.empty(ws[1], device="cuda")
        assert layers._dense_engages(x, w, b) is want
        assert layers._dense_engages(x, w, None) is want


def test_functorch_wrapped_operands_never_engage(no_launch):
    """vmap and grad wrap their operands; such tensors hold no storage
    of their own, and the product stays torch's."""
    x = torch.randn(3, 4, 8)
    p = {"w": torch.randn(8, 5), "b": torch.randn(5)}
    seen = []

    def body(row):
        seen.append(layers._dense_engages(row, p["w"], p["b"]))
        return layers.linear(p, row).sum()

    with torch.no_grad():
        out = torch.vmap(body)(x)
    assert out.shape == (3,)
    torch.func.grad(body)(x[0])
    assert seen == [False, False]


def emulate(x, w, n_terms):
    """x @ w with operands rounded as the kernel rounds them (1: one TF32
    product, 3: the split product), sums in float64."""
    xh, xl = (t.double() for t in tf32_split(x))
    wh, wl = (t.double() for t in tf32_split(w))
    if n_terms == 1:
        return xh @ wh
    return xh @ wh + xh @ wl + xl @ wh


# Swin-B stage 3 (fc1 512 -> 2048, fc2 2048 -> 512) and the ViT's d 192
# (wq 192 -> 192, up 192 -> 768, down 768 -> 192); layernormed inputs,
# LeCun-normal weights, as the detector holds them
EMULATED = [(512, 2048), (2048, 512), (192, 192), (192, 768), (768, 192)]


@pytest.mark.parametrize("k,n", EMULATED, ids=[f"{k}x{n}" for k, n in
                                                 EMULATED])
def test_split_tf32_stays_float32_class(k, n):
    g = torch.Generator().manual_seed(k + n)
    x = torch.randn(256, k, generator=g)
    w = torch.randn(k, n, generator=g) / k ** 0.5
    ref = x.double() @ w.double()
    err_f32 = float(((x @ w).double() - ref).abs().max())
    err1 = float((emulate(x, w, 1) - ref).abs().max())
    err3 = float((emulate(x, w, 3) - ref).abs().max())
    print(f"K {k} N {n}: float32 {err_f32:.2e}, 1xTF32 {err1:.2e}, "
          f"3xTF32 {err3:.2e}")
    assert err1 > DETECTOR_TOL        # one TF32 product breaks the limit
    assert err3 < DETECTOR_TOL / 50
    assert err3 < 4 * err_f32 + 1e-7  # the split keeps float32's bits


def test_n_tile_choices():
    assert [ops.n_tile(n) for n in (192, 768, 384, 128, 256, 512, 1024,
                                    2048, 4096, 5, 70, 257)] == [
        96, 128, 128, 128, 128, 128, 128, 128, 128, 64, 96, 96]
    assert ops.split_floats(512, 2048) == 2 * 512 * 2048   # 2 |w|
    assert ops.split_floats(192, 192) == 2 * 192 * 192
    assert ops.split_floats(13, 5) == 2 * 16 * 64


def prepass_model(w: torch.Tensor) -> torch.Tensor:
    """csrc/dense.cu's dense_split_kernel, thread by thread: thread
    (k4, n) splits w[4 k4 .. 4 k4 + 3, n] (zero past K and N) and writes
    four hi floats, and four lo floats NT * K_CHUNK on, at
    (n / NT * k_chunks + k4 / (K_CHUNK / 4)) * 2 NT K_CHUNK
      + ((n % NT) / 8 * (K_CHUNK / 4) + k4 % (K_CHUNK / 4)) * 32
      + (n % 8) * 4."""
    k, n = w.shape
    nt, kc = ops.n_tile(n), ops.K_CHUNK
    k_chunks = -(-k // kc)
    n_pad = -(-n // nt) * nt
    wp = torch.zeros(k_chunks * kc, n_pad)
    wp[:k, :n] = w
    hi, lo = tf32_split(wp)
    out = torch.full((ops.split_floats(k, n),), float("nan"))
    k4 = torch.arange(k_chunks * kc // 4)[:, None]
    nn = torch.arange(n_pad)[None, :]
    nl = nn % nt
    dst = ((nn // nt * k_chunks + k4 // (kc // 4)) * 2 * nt * kc
           + ((nl // 8) * (kc // 4) + k4 % (kc // 4)) * 32 + (nl % 8) * 4)
    for c in range(4):
        out[dst + c] = hi[4 * k4 + c, nn]
        out[dst + c + nt * kc] = lo[4 * k4 + c, nn]
    return out


def consumer_reads(k: int, n: int) -> tuple:
    """Where the product's wgmma reads element (k, n) of each half: in
    tile n / NT at K chunk k / K_CHUNK, step ks = (k % K_CHUNK) / 8,
    the descriptor's base is the block + 64 ks floats (+ NT K_CHUNK for
    lo), with LBO 128 bytes between the two 8 x 4 core matrices of a
    step along K and SBO 128 (K_CHUNK / 4) bytes between groups of 8
    rows of N; row r of a core matrix at 16 r bytes."""
    nt, kc = ops.n_tile(n), ops.K_CHUNK
    k_chunks = -(-k // kc)
    kk = torch.arange(k)[:, None]
    nn = torch.arange(n)[None, :]
    nl, kin = nn % nt, kk % kc
    base = (nn // nt * k_chunks + kk // kc) * 2 * nt * kc + 64 * (kin // 8)
    lbo, sbo = 128 // 4, 128 * (kc // 4) // 4        # in floats
    off = (nl // 8) * sbo + ((kin % 8) // 4) * lbo + (nl % 8) * 4 + kin % 4
    return base + off, base + nt * kc + off


@pytest.mark.parametrize("k,n", [(512, 2048), (192, 192), (192, 768),
                                 (100, 70), (13, 300), (3, 1)])
def test_prepass_layout_is_what_the_product_reads(k, n):
    g = torch.Generator().manual_seed(k * n)
    w = torch.randn(k, n, generator=g) * 3.0
    buf = prepass_model(w)
    assert not bool(buf.isnan().any())        # every float written once
    hi_at, lo_at = consumer_reads(k, n)
    hi, lo = tf32_split(w)
    assert torch.equal(buf[hi_at], hi) and torch.equal(buf[lo_at], lo)
    read = torch.zeros_like(buf, dtype=torch.bool)
    read[hi_at] = True
    read[lo_at] = True
    assert int(read.sum()) == 2 * k * n       # no two elements collide
    assert bool((buf[~read] == 0).all())      # the padding is zero
