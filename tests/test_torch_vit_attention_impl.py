"""Which attention the ViT detector's backbone runs
(models/detector.py `vit_attention_impl`), on the CPU.

- "flash", the hand-written kernel (one launch a layer), only where the
  tokens and every ViT weight are plain float32 CUDA tensors holding
  values and nothing needs a gradient;
- "xla" for everything else: CPU tensors, gradients under grad mode
  (tokens or weights), other dtypes, functorch-wrapped tensors (vmap),
  DTensors, meta tensors and FakeTensorMode, none of which the kernel
  (it has no backward) may take;
- on the CPU the detector's forward is the "xla" path, bit for bit.

CUDA tensors are FakeTensorMode's, with its own refusal
(layers.shape_only) taken out where the other clauses are under test.
The kernel itself runs on the card: tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs import MADEYE_APPROX_SMOKE as CFG
from repro_torch.kernels import _lib
from repro_torch.launch import mesh as tmesh
from repro_torch.models import detector as det
from repro_torch.models import layers, vit
from repro_torch.train.optim import tree_map

N_TOKENS = (CFG.img_res // CFG.patch) ** 2


@pytest.fixture(scope="module")
def params():
    return det.params_from_numpy(
        det.detector_init(np.random.default_rng(0), CFG), "cpu")


@pytest.fixture
def no_launch(monkeypatch):
    """Anything that reaches the kernel library fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("reached the kernel library")
    monkeypatch.setattr(_lib, "launch", refuse)
    monkeypatch.setattr(_lib, "library", refuse)


@pytest.fixture
def values(monkeypatch):
    """FakeTensorMode's CUDA tensors stand for tensors holding values."""
    monkeypatch.setattr(layers, "shape_only", lambda device=None: False)


def _like(tree, dtype=torch.float32, device="cuda", grad=False):
    return tree_map(lambda t: torch.empty(t.shape, dtype=dtype,
                                          device=device,
                                          requires_grad=grad), tree)


def _tokens(b=2, **kw):
    return torch.empty(b, N_TOKENS, CFG.d_model, **kw)


def test_plain_card_tensors_take_flash(params, values):
    vp = params["backbone"]["vit"]
    with FakeTensorMode():
        tokens, weights = _tokens(device="cuda"), _like(vp)
        assert det.vit_attention_impl(tokens, weights) == "flash"
        trained = _like(vp, grad=True)
        with torch.no_grad():
            assert det.vit_attention_impl(tokens, trained) == "flash"
        with torch.inference_mode():
            assert det.vit_attention_impl(tokens, weights) == "flash"


# each a case where some operand is not a plain float32 CUDA tensor
# holding values, or some gradient is needed
XLA_KINDS = ["cpu", "grad-tokens", "grad-weights", "bfloat16", "float64",
             "cpu-weights"]


@pytest.mark.parametrize("kind", XLA_KINDS)
def test_other_tensors_keep_xla(params, values, kind):
    vp = params["backbone"]["vit"]
    with FakeTensorMode():
        dtype = {"bfloat16": torch.bfloat16,
                 "float64": torch.float64}.get(kind, torch.float32)
        tokens = _tokens(device="cpu" if kind == "cpu" else "cuda",
                         dtype=dtype, requires_grad=kind == "grad-tokens")
        weights = _like(vp, dtype=dtype,
                        device="cpu" if kind.startswith("cpu") else "cuda",
                        grad=kind == "grad-weights")
        assert det.vit_attention_impl(tokens, weights) == "xla"


def test_functorch_wrapped_tokens_keep_xla(params, values):
    """vmap (full-parameter distillation scores each camera's network
    under it) wraps its operands: their storage is not their own."""
    vp = params["backbone"]["vit"]
    seen = []

    def body(x, w):
        seen.append(det.vit_attention_impl(x, w))
        return x.sum()

    with FakeTensorMode():
        tokens, weights = _tokens(3, device="cuda"), _like(vp)
        torch.vmap(body, in_dims=(0, None))(tokens, weights)
        one = torch.empty(N_TOKENS, CFG.d_model, device="cuda")
        torch.vmap(lambda w: body(one, w))(
            tree_map(lambda t: t.expand(2, *t.shape), weights))
    assert seen == ["xla", "xla"]


def test_shape_only_tensors_keep_xla(params):
    """Meta tensors and FakeTensorMode carry no values to launch on."""
    vp = params["backbone"]["vit"]
    assert det.vit_attention_impl(_tokens(device="meta"),
                                  _like(vp, device="meta")) == "xla"
    with FakeTensorMode():
        assert det.vit_attention_impl(_tokens(device="cuda"),
                                      _like(vp)) == "xla"


@pytest.fixture
def one_rank():
    """A one-rank gloo group made by make_debug_mesh, torn down after."""
    assert not dist.is_initialized()
    yield tmesh.make_debug_mesh(device="cpu")
    dist.destroy_process_group()


def test_dtensors_keep_xla(params, values, one_rank, monkeypatch):
    """A DTensor keeps "xla" though it were a float32 CUDA tensor in
    every other respect (the device check is taken out here)."""
    vp = params["backbone"]["vit"]
    rep = [Replicate(), Replicate()]
    tokens = DTensor.from_local(torch.zeros(2, N_TOKENS, CFG.d_model),
                                one_rank, rep, run_check=False)
    weights = tree_map(lambda t: DTensor.from_local(t, one_rank, rep,
                                                    run_check=False), vp)
    assert det.vit_attention_impl(tokens, weights) == "xla"
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda self: torch.device("cuda")))
    assert tokens.device.type == "cuda"
    assert det.vit_attention_impl(tokens, weights) == "xla"
    assert det.vit_attention_impl(tokens.to_local(), vp) == "flash"


def test_cpu_forward_is_the_xla_path(params, no_launch, monkeypatch):
    """On the CPU the backbone is called with impl="xla" and the
    detector's outputs equal, bit for bit, the forward composed with
    impl="xla" by hand."""
    tokens = torch.as_tensor(np.random.default_rng(1).normal(
        0, 1, (3, N_TOKENS, CFG.d_model)).astype(np.float32))
    impls = []
    features = vit.vit_features_tokens

    def recorded(*args, impl="xla", **kw):
        impls.append(impl)
        return features(*args, impl=impl, **kw)

    monkeypatch.setattr(vit, "vit_features_tokens", recorded)
    with torch.no_grad():
        got = det.detector_raw_tokens(params, CFG, tokens)
    assert impls == ["xla"]
    bb = params["backbone"]
    with torch.no_grad():
        want = det.head_outputs(params["heads"], det.neck_features(
            bb, features(bb["vit"], tokens, n_heads=CFG.n_heads,
                         impl="xla")))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
