"""The detector's Swin backbone in the port (models/detector.py over
models/swin.py) on the CPU, at a smoke size: 64 px crops at patch 4,
stages of 2 / 2 / 2 blocks at widths 32 / 64 / 128 in windows of 4 (two
shifted stages, two merges, a last map no larger than its window).

crop_patchify at patch 4 against an independent render + strided
convolution, and the kernel's sizing and weight layout at Swin-B's
shape; Swin's per-step constants made once; the config's refusals;
head-only distillation in the episode with the Swin backbone and the
full-parameter mode's refusal; the `madeye/backbone` span; the ViT
detector's tree as it was. (The port against the benchmark's plain
reference: bench/tests/test_bench_swin.py.)
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import dataclasses

from repro_torch.configs import DetectorConfig, VisionConfig
from repro_torch.fleet.api import FleetRunSpec, prepare_fleet_run
from repro_torch.fleet.runner import episode_step
from repro_torch.kernels.crop_patchify import ops as cp
from repro_torch.learn.spec import DistillSpec
from repro_torch.models import attention as attn
from repro_torch.models import detector as det
from repro_torch.models import swin
from repro_torch.obs.trace import tracing
from repro_torch.scene.render import (
    object_colors,
    render_background,
    render_crops_plain,
)
from torch_kernel_inputs import patchify_inputs, t

SWIN_BACKBONE = VisionConfig(
    name="swin-smoke", img_res=64, patch=4, n_layers=6, d_model=32,
    n_heads=1, d_ff=128, swin=True, window=4, depths=(2, 2, 2),
    dims=(32, 64, 128), dtype=torch.float32)
SWIN = DetectorConfig(name="swin-smoke", img_res=64, patch=4, max_boxes=8,
                      fpn_dim=32, swin=SWIN_BACKBONE)
VIT = DetectorConfig(
    name="vit-smoke", img_res=64, patch=16, n_layers=2, d_model=48,
    n_heads=3, d_ff=96, max_boxes=8, fpn_dim=32)


def _patch4_inputs(f, k, d, res, seed):
    pos, size, kind, oid, wins, _, _ = patchify_inputs(f, k, d, seed=seed,
                                                       shared=False)
    rng = np.random.default_rng(seed + 1)
    pe = {"w": t(rng.normal(0, 0.1, (4, 4, 3, d)).astype(np.float32)),
          "b": t(rng.normal(0, 0.01, d).astype(np.float32))}
    noise = t((0.05 * rng.normal(0, 1, (f, res, res, 3))).astype(
        np.float32))
    return t(pos), t(size), t(kind), t(oid), t(wins), pe, noise


@pytest.mark.parametrize("res,block_k", [(64, 2), (224, None)])
def test_crop_patchify_patch4_matches_render_and_conv(res, block_k):
    """Swin's tokens (patch 4, width 128): crop_patchify's plain path
    against the crops rendered and embedded by a stride-4 convolution.
    Float32 products summed in other orders: 1e-5 on values of order
    1."""
    f, k, d = 2, 4, 128
    pos, size, kind, oid, wins, pe, noise = _patch4_inputs(f, k, d, res, 4)
    got = cp.crop_patchify(pos, size, kind, oid, wins, pe, patch=4,
                           res=res, min_visible=0.25, noise=noise,
                           block_k=block_k)
    g = res // 4
    assert got.shape == (f, k, g * g, d)
    crops = render_crops_plain(
        pos[..., 0], pos[..., 1], size[..., 0], size[..., 1],
        object_colors(kind, oid), wins,
        render_background(res)[None] + noise, res=res, min_visible=0.25)
    y = F.conv2d(crops.reshape(f * k, res, res, 3).permute(0, 3, 1, 2),
                 pe["w"].permute(3, 2, 0, 1), pe["b"], stride=4)
    want = y.permute(0, 2, 3, 1).reshape(f, k, g * g, d)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_crop_patchify_kernel_takes_swin_b_shape():
    """At 576 crops of 224 px, patch 4, D 128 and 22 or 40 object slots
    the kernel's shared memory fits its budget, and the split weights
    hold the 48 x 128 patch embed in their first K chunk and feature
    tile, zero past both."""
    for m in (22, 40):
        assert cp.kernel_shared_bytes(m, 224, 4, 128, 576) <= cp.SMEM_LIMIT
    w = torch.randn(48, 128)
    ws = cp.tf32_split_weights(w)
    nt = cp.n_tile(128)
    assert ws.shape == (1, 1, 2, nt // 8, cp.K_CHUNK // 4, 8, 4)
    # undo the core-matrix order: [2, N, K]
    full = ws[0, 0].permute(0, 1, 3, 2, 4).reshape(2, nt, cp.K_CHUNK)
    torch.testing.assert_close(full.sum(0)[:128, :48], w.t(), rtol=0,
                               atol=1e-6)
    assert not full[:, 128:].any() and not full[:, :, 48:].any()


def test_swin_constants_made_once():
    idx = swin.rel_index(4, "cpu")
    assert swin.rel_index(4, torch.device("cpu")) is idx
    np.testing.assert_array_equal(idx.numpy(), swin._rel_position_index(4))
    mask = swin.shift_mask(8, 8, 4, 2, "cpu")
    assert swin.shift_mask(8, 8, 4, 2, "cpu") is mask
    torch.testing.assert_close(mask, attn.shifted_window_mask(8, 8, 4, 2),
                               rtol=0, atol=0)
    # values carry nothing under a FakeTensorMode: built, never kept
    from torch._subclasses.fake_tensor import FakeTensorMode

    n = len(swin._CONSTANTS)
    with FakeTensorMode():
        swin.shift_mask(16, 16, 4, 2, "cpu")
        swin.rel_index(5, "cpu")
    assert len(swin._CONSTANTS) == n


@pytest.mark.parametrize("kw", [
    dict(swin=dataclasses.replace(SWIN_BACKBONE, swin=False)),
    dict(swin=dataclasses.replace(SWIN_BACKBONE, depths=(2,), dims=(32,))),
    dict(swin=dataclasses.replace(SWIN_BACKBONE, patch=8)),
    dict(swin=dataclasses.replace(SWIN_BACKBONE, dtype=torch.bfloat16)),
    dict(swin=SWIN_BACKBONE, n_layers=6, d_model=32, n_heads=1, d_ff=128),
    dict()],
    ids=["not_swin", "one_stage", "other_patch", "bf16", "vit_widths_too",
         "no_backbone"])
def test_config_refusals(kw):
    with pytest.raises(ValueError, match="backbone"):
        DetectorConfig(name="x", img_res=64, patch=4, **kw)


def test_trees_and_helpers():
    g = torch.Generator().manual_seed(0)
    vp = det.detector_init(g, VIT, "cpu")
    assert set(vp["backbone"]) == {"vit", "neck"}
    assert set(vp["backbone"]["neck"]) == {"lateral", "smooth"}
    assert det.patch_embed_params(vp, VIT) is \
        vp["backbone"]["vit"]["patch_embed"]
    sp = det.detector_init(g, SWIN, "cpu")
    assert set(sp["backbone"]) == {"swin", "neck"}
    assert set(sp["backbone"]["neck"]) == {"lateral3", "lateral4", "smooth"}
    assert [len(st["blocks"]) for st in sp["backbone"]["swin"]["stages"]] \
        == [2, 2, 2]
    assert det.patch_embed_params(sp, SWIN)["w"].shape == (4, 4, 3, 32)
    assert (det.neck_grid(VIT), det.neck_grid(SWIN)) == (4, 8)
    tokens = torch.randn(3, 256, 32)
    with torch.no_grad():
        feats = det.detector_neck_feats_tokens(sp, SWIN, tokens)
        assert feats.shape == (3, 8, 8, 32)
        # the image path embeds with the Swin patch embed
        images = torch.rand(2, 64, 64, 3)
        a = det.detector_forward(sp, SWIN, images)
        pe = sp["backbone"]["swin"]["patch_embed"]
        tok = F.conv2d(images.permute(0, 3, 1, 2),
                       pe["w"].permute(3, 2, 0, 1), pe["b"], stride=4)
        b = det.detector_forward_tokens(
            sp, SWIN, tok.permute(0, 2, 3, 1).reshape(2, 256, 32))
    torch.testing.assert_close(a.scores, b.scores, rtol=0, atol=1e-5)


def test_swin_tree_round_trips_by_paths(tmp_path):
    """A Swin tree spelled by paths (stages and blocks keyed "0", "1",
    ..., as a `.npz` checkpoint's names and the benchmark's leaves spell
    it) reads back as the lists the port draws, leaf for leaf."""
    from repro_torch.fleet.runner import (
        load_detector_params,
        save_detector_params,
    )

    sp = det.detector_init(torch.Generator().manual_seed(2), SWIN, "cpu")
    back = load_detector_params(
        save_detector_params(str(tmp_path / "swin.npz"), sp), "cpu")
    flat = [(a, b) for a, b in zip(_leaves(sp), _leaves(back))]
    assert len(flat) == len(_leaves(sp)) > 0
    for (pa, a), (pb, b) in flat:
        assert pa == pb and torch.equal(a, b)
    by_paths = {"stages": {str(i): {"blocks": {str(j): b for j, b in
                                               enumerate(st["blocks"])}}
                           for i, st in enumerate(
                               sp["backbone"]["swin"]["stages"])}}
    got = det.params_from_numpy(by_paths)["stages"]
    assert isinstance(got, list) and isinstance(got[0]["blocks"], list)


def _leaves(tree, pre=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{pre}/{k}")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v,
                                                               f"{pre}/{i}")]
    return [(pre, tree)]


@pytest.mark.parametrize("cfg", [VIT, SWIN], ids=["vit", "swin"])
def test_backbone_span(cfg):
    params = det.detector_init(torch.Generator().manual_seed(1), cfg, "cpu")
    n = (cfg.img_res // cfg.patch) ** 2
    d = det.patch_embed_params(params, cfg)["w"].shape[-1]
    with tracing() as tr, torch.no_grad():
        det.detector_forward_tokens(params, cfg, torch.randn(2, n, d))
    assert [e["name"] for e in tr.events] == ["madeye/backbone"]


def _prepared(distill, n_steps=3):
    spec = FleetRunSpec(provider="detector", n_cameras=2, n_steps=n_steps,
                        shortlist_k=6, distill=distill, budget={"fps": 3.0},
                        provider_kwargs={"det_cfg": SWIN})
    return prepare_fleet_run(spec, device="cpu")


def test_head_only_distillation_step_with_swin():
    """One in-episode head-only update on the Swin backbone's post-neck
    features: the staged payload is the [F, K, 8, 8, 32] neck map, the
    shared backbone is untouched and the per-camera heads move."""
    p = _prepared(DistillSpec(every=1))
    state, carry = p.state, p.provider.init_carry(p.state)
    heads0 = carry[2].params
    with torch.no_grad():
        state, carry, out, ex = episode_step(p.cfg, p.wl, p.statics, state,
                                             p.provider, carry, 0)
    lc = carry[2]
    assert lc.staged.shape == (2, 6, 8, 8, 32)
    assert carry[1] is p.provider.det_params
    loss = ex["learn"]["loss"]
    assert loss.shape == (2,) and bool(torch.isfinite(loss).all())
    moved = [not torch.equal(a, b) for a, b in zip(
        (heads0["obj"]["w"], heads0["cls"]["w"]),
        (lc.params["obj"]["w"], lc.params["cls"]["w"]))]
    assert any(moved) == bool((loss >= 0).any())


def test_full_parameter_distillation_refused_with_swin():
    with pytest.raises(NotImplementedError, match="full-parameter"):
        p = _prepared(DistillSpec(head_only=False))
        p.provider.init_carry(p.state)
