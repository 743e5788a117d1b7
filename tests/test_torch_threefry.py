"""The threefry kernel's wrapper on the CPU (kernels/threefry/ops.py;
the kernel itself runs only on the card: tests/test_torch_prng_cuda.py).

CPU keys draw through scene/prng.py's plain version and never reach the
kernel library; the wrapper refuses bad keys, data and ranges before
it launches; the key and data rows it hands the kernel walk the same
elements as the broadcast tensors; the kernel's float constants are
the plain version's.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.threefry import ops  # noqa: E402
from repro_torch.scene import prng  # noqa: E402

SOURCE = Path(_lib.CSRC) / "threefry.cu"


@pytest.fixture
def no_library(monkeypatch):
    """_lib's loader and launcher replaced by ones that fail."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel library was reached")

    monkeypatch.setattr(_lib, "library", refuse)
    monkeypatch.setattr(_lib, "launch", refuse)
    _lib.reset_launch_counts()
    yield
    assert _lib.launch_counts()["threefry"] == 0


def _keys(n=4):
    return prng.fold_in(prng.PRNGKey(5), torch.arange(n))


CPU_DRAWS = {
    "fold_in_int": lambda k: prng.fold_in(k, 7),
    "fold_in_tensor": lambda k: prng.fold_in(k, torch.arange(4)),
    "split": lambda k: prng.split(k, 8),
    "random_bits": lambda k: prng.random_bits(k, (22, 2)),
    "uniform": lambda k: prng.uniform(k, (22,), 0.5, 2.0),
    "uniform_tensor_bounds": lambda k: prng.uniform(
        k, (3, 2), torch.tensor([15.0, 10.0]), torch.tensor([135.0, 65.0])),
    "randint": lambda k: prng.randint(k[:, None], (22,), 0, 5),
    "normal": lambda k: prng.normal(k, (22, 4)),
}


@pytest.mark.parametrize("name", sorted(CPU_DRAWS))
def test_cpu_draws_never_reach_the_library(no_library, name):
    out = CPU_DRAWS[name](_keys())
    assert out.device.type == "cpu" and out.shape[0] == 4


def test_cpu_scene_step_never_reaches_the_library(no_library):
    from repro_torch.scene import render
    from repro_torch.scene import scene as sc
    spec = sc.SceneSpec()
    params, rng = sc.scene_fleet_params(spec, 3)
    state = sc.advance_scene(spec, params, rng, sc.init_scene(spec, params,
                                                              rng), 2, 1)
    noise = render.render_noise(rng, torch.tensor(2), 8)
    assert state.pos.shape == (3, spec.max_objects, 2)
    assert noise.shape == (3, 8, 8, 3)


KEY = torch.zeros((4, 2), dtype=torch.int64)
REFUSED = {
    "int32 keys": (TypeError, "int64",
                   lambda: ops.split(KEY.to(torch.int32))),
    "float keys": (TypeError, "int64",
                   lambda: ops.random_bits(KEY.double(), (3,))),
    "a list of keys": (TypeError, "int64",
                       lambda: ops.normal([0, 1], (3,), -1.0, 1.0)),
    "3-word keys": (ValueError, r"\[\.\.\., 2\]",
                    lambda: ops.uniform(torch.zeros((4, 3), dtype=torch.int64),
                                        (3,), 0.0, 1.0)),
    "0-d keys": (ValueError, r"\[\.\.\., 2\]",
                 lambda: ops.fold_in(torch.tensor(3), 1)),
    "a negative dim": (ValueError, "negative",
                       lambda: ops.random_bits(KEY, (3, -1))),
    "float data": (TypeError, "data must be int64",
                   lambda: ops.fold_in(KEY, torch.ones(4))),
    "int32 data": (TypeError, "data must be int64",
                   lambda: ops.fold_in(KEY, torch.ones(4, dtype=torch.int32))),
    "data off the key batch": (RuntimeError, "(?i)shape",
                               lambda: ops.fold_in(KEY, torch.arange(3))),
    "an empty randint range mod 2**32": (
        ValueError, "modulo", lambda: ops.randint(KEY, (3,), 0, 2 ** 32)),
    "CPU keys": (ValueError, "CUDA",
                 lambda: ops.randint(KEY, (3,), 0, 4)),
    "CPU keys with int data": (ValueError, "CUDA",
                               lambda: ops.fold_in(KEY, 3)),
    "CPU keys with tensor data": (ValueError, "CUDA",
                                  lambda: ops.fold_in(KEY, torch.arange(4))),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_wrapper_refuses_before_launch(no_library, case):
    err, match, call = REFUSED[case]
    with pytest.raises(err, match=match):
        call()


def _walk(t, row, word, rows):
    """The kernel's reads: row r at offset r * row, words 0 and `word`."""
    return torch.as_strided(t, (rows, 2), (row, word), t.storage_offset())


KEYS = torch.arange(2 * 6 * 8 * 2).reshape(2, 6, 8, 2)
KEY_LAYOUTS = {
    "contiguous [F, 2]": (KEYS[0, :, 0], (6,)),
    "slice ks[:, 0] of [F, 8, 2]": (KEYS[0, :, 3], (6,)),
    "one key over a batch": (KEYS[0, 0, 0], (6,)),
    "[A, B, 2] contiguous": (KEYS[0], (6, 8)),
    "[A, B, 2] sliced": (KEYS[:, :, 1], (2, 6)),
    "[F, 1, 2] over [F, T] (copied)": (KEYS[0, :, :1], (6, 5)),
    "transposed [B, A, 2] (copied)": (KEYS[0].transpose(0, 1), (8, 6)),
    "[F, 2] over [T, F]": (KEYS[0, :, 0], (5, 6)),
}


@pytest.mark.parametrize("layout", sorted(KEY_LAYOUTS))
def test_key_rows_walk_the_broadcast_keys(layout):
    key, batch = KEY_LAYOUTS[layout]
    want = key.expand(*batch, 2).reshape(-1, 2)
    t, row = ops._rows(key, batch, 1)
    assert t is key or t.is_contiguous()
    got = _walk(t, row, t.stride(-1), want.shape[0])
    assert torch.equal(got, want)


@pytest.mark.parametrize("layout", ["scalar", "[F]", "strided [F]",
                                    "[F] over [T, F]", "[F, 1] over [F, T]"])
def test_data_rows_walk_the_broadcast_data(layout):
    base = torch.arange(100)
    data, batch = {"scalar": (base[3], (6,)), "[F]": (base[:6], (6,)),
                   "strided [F]": (base[::3][:6], (6,)),
                   "[F] over [T, F]": (base[:6], (4, 6)),
                   "[F, 1] over [F, T]": (base[:6, None], (6, 4))}[layout]
    want = data.expand(*batch).reshape(-1)
    t, row = ops._rows(data, batch, 0)
    got = torch.as_strided(t, (want.shape[0],), (row,), t.storage_offset())
    assert torch.equal(got, want)


def test_kernel_constants_are_the_plain_versions():
    src = SOURCE.read_text()
    pairs = re.findall(r"lt \? (-?[0-9.e+-]+)f : (-?[0-9.e+-]+)f", src)
    assert len(pairs) == len(prng._ERFINV_LT5) == len(prng._ERFINV_GE5)
    f32 = np.float32
    assert [f32(a) for a, _ in pairs] == [f32(c) for c in prng._ERFINV_LT5]
    assert [f32(b) for _, b in pairs] == [f32(c) for c in prng._ERFINV_GE5]
    sqrt2 = re.search(r"kSqrt2 = ([0-9.]+)f;", src).group(1)
    assert f32(sqrt2) == f32(prng._SQRT2)
    assert "threefry.cu" in _lib.SOURCES and "threefry" in _lib.KERNELS
