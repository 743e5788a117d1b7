"""The port's box_iou, frame_delta and rmsnorm APIs (plain versions on
the CPU) against the JAX package's (Pallas kernels in interpret mode) on
the same seeded numpy inputs.

Tolerances: IoU 1e-6 (the same float32 ops in the same order); NMS keep
masks, matches, changed-tile masks, int8 residuals and bytes_est exact;
the decoded frame 1 ulp (XLA fuses its multiply-add into an FMA);
rmsnorm 1e-6 in float32 (a 1-ulp rsqrt and a sum in another order) and
2e-2 in bfloat16 (one bf16 rounding of the output).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: intra-op threads only contend with the other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.box_iou import ops as jbox  # noqa: E402
from repro.kernels.frame_delta import ops as jfd  # noqa: E402
from repro.kernels.rmsnorm import ops as jrms  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.box_iou.ops import (  # noqa: E402
    box_iou,
    match_boxes,
    nms_mask,
)
from repro_torch.kernels.frame_delta.ops import (  # noqa: E402
    apply_delta,
    frame_delta,
)
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402


def _boxes(n, seed):
    rng = np.random.default_rng(seed)
    b = np.abs(rng.normal(0, 1, (n, 4))) * 0.3 + 0.05
    return b.astype(np.float32)


@pytest.mark.parametrize("n,m", [(8, 8), (37, 13), (128, 256), (5, 300),
                                 (1, 1)])
def test_box_iou_matches_jax(n, m):
    a, b = _boxes(n, n), _boxes(m, m + 1)
    _lib.reset_launch_counts()
    got = box_iou(torch.as_tensor(a), torch.as_tensor(b))
    assert _lib.launch_counts()["box_iou"] == 0            # plain on CPU
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jbox.box_iou(jnp.asarray(a),
                                             jnp.asarray(b))), atol=1e-6)


def _detections(n, seed):
    """n boxes in a few tight clusters (so NMS and matching bite), with
    tied scores and some invalid slots."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (4, 2))
    c = centers[rng.integers(0, 4, n)] + rng.normal(0, 0.02, (n, 2))
    wh = rng.uniform(0.05, 0.2, (n, 2))
    boxes = np.concatenate([c, wh], 1).astype(np.float32)
    scores = np.round(rng.uniform(0, 1, n), 1).astype(np.float32)  # ties
    valid = rng.random(n) < 0.8
    return boxes, scores, valid


@pytest.mark.parametrize("n,seed", [(32, 0), (32, 1), (17, 2), (3, 3)])
def test_nms_mask_matches_jax(n, seed):
    boxes, scores, valid = _detections(n, seed)
    for thresh in (0.3, 0.5):
        want = jbox.nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                             jnp.asarray(valid), iou_thresh=thresh)
        got = nms_mask(torch.as_tensor(boxes), torch.as_tensor(scores),
                       torch.as_tensor(valid), iou_thresh=thresh)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,m,seed", [(32, 20, 0), (32, 32, 1), (9, 4, 2)])
def test_match_boxes_matches_jax(n, m, seed):
    pred, _, _ = _detections(n, seed)
    gt, _, gt_valid = _detections(m, seed + 10)
    gt[: m // 4] = pred[: m // 4]                  # some exact matches
    for thresh in (0.3, 0.5):
        want = jbox.match_boxes(jnp.asarray(pred), jnp.asarray(gt),
                                jnp.asarray(gt_valid), iou_thresh=thresh)
        got = match_boxes(torch.as_tensor(pred), torch.as_tensor(gt),
                          torch.as_tensor(gt_valid), iou_thresh=thresh)
        assert got[1].dtype == torch.int32
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_nms_and_match_small_cases():
    boxes = torch.tensor([[0.5, 0.5, 0.2, 0.2], [0.51, 0.5, 0.2, 0.2],
                          [0.9, 0.9, 0.1, 0.1]])
    keep = nms_mask(boxes, torch.tensor([0.9, 0.8, 0.7]),
                    torch.ones(3, dtype=torch.bool))
    assert keep.tolist() == [True, False, True]
    tp, m = match_boxes(boxes[:1].repeat(2, 1), boxes[:1],
                        torch.ones(1, dtype=torch.bool))
    assert tp.tolist() == [True, False] and m.tolist() == [0, -1]


def _frames(h, w, seed):
    rng = np.random.default_rng(seed)
    cur = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    prev = cur.copy()
    prev[: h // 2, : w // 2] = np.clip(prev[: h // 2, : w // 2] + 0.3, 0, 1)
    prev[h // 2:, w // 2:] += rng.normal(0, 0.004, prev[h // 2:,
                                                         w // 2:].shape)
    return cur, prev.astype(np.float32)


@pytest.mark.parametrize("hw,tile", [((128, 128), (16, 128)),
                                     ((100, 200), (16, 128)),
                                     ((37, 53), (8, 16)),
                                     ((224, 224), (16, 128))])
def test_frame_delta_matches_jax(hw, tile):
    """Ragged H and W: edge tiles are zero-padded in the mean."""
    cur, prev = _frames(*hw, seed=hw[0])
    th, tw = tile
    want = jfd.frame_delta(jnp.asarray(cur), jnp.asarray(prev), tile_h=th,
                           tile_w=tw)
    got = frame_delta(torch.as_tensor(cur), torch.as_tensor(prev),
                      tile_h=th, tile_w=tw)
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.int32
    assert got[0].shape == cur.shape
    for name, g, w in zip(("delta_q", "changed", "bytes_est"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert 0 < int(got[1].sum()) < got[1].numel()          # both kinds


def test_apply_delta_matches_jax():
    cur, prev = _frames(64, 128, 1)
    prev = np.clip(cur + 0.2, 0, 1)                        # all tiles move
    dq, _, _ = frame_delta(torch.as_tensor(cur), torch.as_tensor(prev))
    want = jfd.apply_delta(jnp.asarray(prev), jnp.asarray(dq.numpy()))
    got = apply_delta(torch.as_tensor(prev), dq)
    # XLA fuses the multiply-add into one FMA: 1 ulp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1.2e-7)
    assert float((got - torch.as_tensor(cur)).abs().max()) < 1 / 127 + 1e-3


def test_frame_delta_identical_frames_send_nothing():
    cur, _ = _frames(64, 128, 2)
    dq, changed, nbytes = frame_delta(torch.as_tensor(cur),
                                      torch.as_tensor(cur))
    assert int(changed.sum()) == 0 and not bool(dq.any())
    assert int(nbytes) == changed.numel() // 8 + 4


FD_THREADS = 128        # csrc/frame_delta.cu's kThreads


def frame_delta_variant(w, c, tile_h, tile_w):
    """(kVec, kIter) the frame_delta launch picks for aligned pointers:
    16-float items kept in registers where every tile row starts on 16
    floats and the tile fits, else scalar items and (kIter 0) a second
    read."""
    aligned = (w * c) % 16 == 0 and (tile_w * c) % 16 == 0
    if aligned and tile_h * tile_w * c <= 16 * 4 * FD_THREADS:
        return 16, 4
    return 1, 0


def frame_delta_walk(h, w, c, tile_h, tile_w, by, bx):
    """The (row, item) pairs each thread of tile (by, bx) visits, by the
    kernel's stepping (no division per item): the model of the walk in
    csrc/frame_delta.cu."""
    kvec, kiter = frame_delta_variant(w, c, tile_h, tile_w)
    x0, y0 = bx * tile_w, by * tile_h
    items_row = tile_w * c // kvec
    items_valid = (min(x0 + tile_w, w) - x0) * c // kvec
    rows_valid = min(y0 + tile_h, h) - y0
    dr, dj = FD_THREADS // items_row, FD_THREADS % items_row
    seen = []
    for tid in range(FD_THREADS):
        r, j = tid // items_row, tid % items_row
        k = 0
        while (k < kiter) if kiter else (r < rows_valid):
            if r < rows_valid and j < items_valid:
                seen.append((r, j))
            r, j = r + dr, j + dj
            if j >= items_row:
                r, j = r + 1, j - items_row
            k += 1
    return kvec, seen


@pytest.mark.parametrize("h,w,tile", [
    (64, 128, (16, 128)), (37, 53, (8, 16)), (40, 160, (8, 16)),
    (37, 53, (16, 64)), (70, 130, (16, 128)), (64, 512, (64, 256)),
    (50, 300, (32, 100)), (1080, 1920, (16, 128))])
def test_frame_delta_kernel_walk_covers_tiles(h, w, tile):
    """Every in-frame element of the first and the edge tiles is visited
    once, and nothing outside the frame is."""
    c = 3
    th, tw = tile
    gh, gw = -(-h // th), -(-w // tw)
    for by, bx in {(0, 0), (gh - 1, 0), (0, gw - 1), (gh - 1, gw - 1)}:
        kvec, seen = frame_delta_walk(h, w, c, th, tw, by, bx)
        assert len(seen) == len(set(seen))
        elems = {(by * th + r, bx * tw * c + j * kvec + e)
                 for r, j in seen for e in range(kvec)}
        want = {(y, x * c + e) for y in range(by * th, min(by * th + th, h))
                for x in range(bx * tw, min(bx * tw + tw, w))
                for e in range(c)}
        assert elems == want


@pytest.mark.parametrize("shape", [(4, 16, 64), (2, 100, 256), (7, 33),
                                   (1, 1, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(shape, dtype):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = rng.normal(0, 1, shape).astype(np.float32)
    w = (rng.normal(0, 1, shape[-1]) + 1.0).astype(np.float32)
    want = jrms.rmsnorm(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w))
    got = rmsnorm(torch.as_tensor(x).to(getattr(torch, dtype)),
                  torch.as_tensor(w))
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (3, 5, 40)).astype(np.float32)
    scale = rng.normal(1, 0.1, 40).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)},
                           jnp.asarray(x, getattr(jnp, dtype)))
    got = tlayers.rmsnorm({"scale": torch.as_tensor(scale)},
                          torch.as_tensor(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-2 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)
    assert tlayers.rmsnorm_init(40)["scale"].shape == (40,)
