"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (every one must pass; the exit code is non-zero otherwise):

  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from src/repro_torch/csrc with nvcc (one
     process per source, all started together) and count each kernel's
     tensor-core instructions (HGMMA/HMMA) in the library's SASS;
  3. hold each kernel against its plain PyTorch version on the card —
     neighbor_score (the kernel API the shape search used to launch),
     cell_rasterize (the kernel API the oracle pass used to launch) and
     crop_patchify at the main path's shapes and at the swinb-f32-k18
     cell's (Swin-B's patch 4 and width 128, 32 x 18 crops), then
     flash_attention (the ViT's layer, stablelm-3b's causal width, GQA
     with q_offset, bf16, and 192- and 256-wide heads), box_iou (bit-equal),
     frame_delta and rmsnorm at full-size shapes, threefry (bit-equal)
     on every draw of a scene step and on the render noise, dense (the
     models' float32 linears: split TF32, bias and GELU fused) at
     swinb-f32-k18's stage-3 fc1 and stage-4 fc2 and approx-f256-k18's
     up-projection, wq and down-projection — and time
     each with CUDA events beside its bound and, where one PyTorch call
     computes the same function, that call; kernels whose device time
     is near or below a Python call's dispatch time also get a
     device-only time (a CUDA graph of the calls, replayed);
  4. check the port end to end on a small input: run_fleet on the card
     and on the CPU (plain versions) must make the same decisions;
  5. drive the main path once — run_fleet(provider="detector") at the
     full width of madeye-approx, 64 cameras, 8 steps, shortlist_k=18 —
     with the launch counters set to 0 just before and read just after;
     each of the four main-path kernels (shape_search, budget_walk,
     oracle_pass, crop_patchify) must have launched once per step,
     threefry 19 times in each step (the scene advance's 16 draws and
     the render noise's 3), dense 36 times in each (the ViT's linears),
     and no other (run_fleet runs the
     reference's plain attention, the shape search scores its
     candidates inside shape_search and the oracle pass rasterizes
     inside oracle_pass); the result must be well
     formed. The inputs and outputs of every oracle_pass, shape_search
     and budget_walk call of the episode are recorded, and the plain
     versions must give the same tables and make the same decisions on
     each (the search kernels also on seeded random states at the same
     shapes); the three kernels are timed on the last step's inputs
     (and the search kernels, printed only, on random states at larger
     fleets and grids);
  5b. drive the learning path (in-episode distillation, paper §3.4):
     run_fleet with distill=DistillSpec() (head-only AdamW, the paper's
     mode) and metrics=MetricsSpec() at the same cell, then with
     DistillSpec(head_only=False) at 3 steps (depth cut to stay inside
     the time limit), counters set to 0 just before and read just after:
     the four main-path kernels once per step and no other (the update
     launches none); every recorded oracle_pass, shape_search,
     budget_walk and crop_patchify call equal to its plain version; the
     per-step loss finite and >= 0; the learned heads moved; the
     backbone (full mode: the patch embedding) bit-unchanged. Prints
     steady_s, its ratio to the frozen run's, peak memory, the loss per
     step and the chosen_rank median; then the smoke detector with
     learning on, 2 cameras, 8 steps, on the card and on the CPU: equal
     decisions, loss and learned heads within stated tolerances;
  6. drive the ViT flash path: the main path's own crop_patchify tokens
     (64 cameras x 18 crops) through vit_features_tokens(impl="flash")
     with the counters set to 0 just before — flash_attention must launch
     once per layer — and through impl="xla"; both go on through the
     neck, heads and decode, and features and detections must agree;
  7. drive the kernel APIs (box_iou, nms_mask, match_boxes, frame_delta
     over one 1080p frame per camera, rmsnorm) with the counters set to
     0 just before and read just after; then time box_iou on those
     detections (the dense case) and nms_mask / match_boxes per call;
  8. drive the main path past the kernels' old limits: run_fleet at full
     width on the 200-cell 7.5-degree grid with a 40-slot scene, 16
     cameras, 3 steps, counters set to 0 just before and read just
     after (crop_patchify, oracle_pass, shape_search and budget_walk
     once per step, each call equal to its plain version); the same
     spec at 2 cameras on the card and on the CPU must decide alike;
     oracle_pass on a 256-slot scene;
  8b. drive the serving launcher (`repro_torch.launch.serve.serve`, the
     `python -m repro_torch.launch.serve` entry point) inside a trace:
     at its defaults (5 fps, 20 s: 100 controller steps) with a
     64-camera `tables` fleet and JSONL telemetry, counters set to 0
     just before and read just after (shape_search and budget_walk once
     per step, 101 with the warm-up, and no other kernel; every call
     equal to its plain version); the spans fleet/build, fleet/compile
     and fleet/steady in the trace and every event valid; the same
     fleet through run_fleet(FleetRunSpec.from_objects("tables", ...))
     on the 200-cell grid (the kernels' four-word instances); serve
     --fleet 4 on the card and on the CPU (equal printed accuracies and
     decisions); and serve --fleet 8 --provider detector --shortlist-k
     18 --distill --telemetry over 5 steps (the four main-path kernels
     once per step and no other, each call equal to its plain version,
     events carrying distill_loss);
  8c. drive this slice's paths (PR 19): the unfused detector reference
     (run_fleet with provider_kwargs fused=False at the main path's
     cell, exhaustive: 75 windows, 15 a slab) and the fused path at
     shortlist_k=75, counters set to 0 just before and read just after
     each (the unfused run launches oracle_pass, shape_search and
     budget_walk once per step and crop_patchify never; the fused run all
     four), every recorded call equal to its plain version; then the
     anchor (weights drawn by numpy from a seed, the same under any
     PyTorch): windows with a detection within 1e-4 of a score
     threshold may be at most 0.1% of the windows; the two runs'
     per-window tables agree but on windows with a detection within
     1e-4 of a decision boundary (a threshold, the top-k cut, a class
     tie), which may be at most 0.1% of the windows too; each camera
     decides alike up to its first step holding a differing window; the unfused step split into render and detector forward;
     materialize_scene_tables on a homogeneous 64-camera fleet (the
     tables episode decides as the scene episode); the serving engine
     (run_fleet_detector_controller decides as run_fleet;
     InferenceEngine.counts_and_areas card vs CPU on 64 full-width
     images); three host finetune_step calls card vs CPU (loss within
     1e-4 relative, backbone bit-unchanged); and the three
     `python -m repro_torch.examples.*` as subprocesses on the card;
  8d. drive the LM half of the model zoo (PR 20), counters set to 0
     just before and read just after each call: stablelm-3b at full
     width and depth in float32 (4 requests of 2048 prompt tokens + 16
     continuation tokens): lm_forward with impl="flash" (flash_attention
     once per layer, 32, dense once per linear, 225, and no other
     kernel) and impl="xla" (dense, 225), gqa_prefill over the prompts
     (dense, 225) and 16 teacher-forced gqa_decode_steps (no kernel: 4
     rows keep torch's product);
     flash vs xla and prefill vs forward within the flash kernel's float32
     tolerance scaled to the logits, each decode step vs the forward's
     position within the bf16 cache's tolerance, argmax equal wherever
     the top-2 margin is clear; then the same weights in bf16, timed
     (prefill last_only, decode ms a step and tokens/s at batch 4, the
     forward with flash and xla, peak memory) and the flash kernel at
     [4, 2064, 32, 80] causal bf16 beside its bound and SDPA; deepseek-v3
     at full width, depth cut to 4 layers (3 dense + 1 MoE), bf16, 2 x
     512 tokens: moe_lm_forward with flash (4 launches, MLA heads of 192
     with v padded) and xla with room in every expert, mla_prefill
     against the forward over the same prompt as configured and 8
     mla_decode_steps against the roomy forward (each on the tokens the
     MoE layer treated alike in both runs, the same experts and the same
     of them kept: max abs error, argmax at clear margins), dropped_frac, the MoE layer's ms, peak memory, the flash
     kernel at [2, 512, 128, 192] causal bf16; and the four
     SMOKE configs on the card and on the CPU (weights drawn by numpy):
     forward, prefill and decode logits within stated tolerances, router
     ids and the dispatch plan equal but at a near tie;
  8e. drive the vision and diffusion half of the model zoo,
     counters set to 0 just before and read just after each call:
     ViT-H/14, ViT-B/16 and ViT-S/16 at full width and depth, float32
     at batch 8 (vit_forward impl="flash" launches flash_attention once
     per layer and nothing else, impl="xla" nothing; logits within the
     flash kernel's float32 tolerance scaled to them), then bf16 at
     serve_b128 (224 px, batch 128: ms a forward and images/s with each
     impl); the flash kernel at ViT-H/14's [128, 257, 16, 80] and
     ViT-B/16's [128, 197, 12, 64] bf16 beside its bound and SDPA;
     Swin-B at full width and depth, bf16, at serve_b128 and at 384 px
     (windows 12); DiT-L/2 (a float32 forward against bf16, then
     dit_sample at gen_fast: 512 px, batch 16, 4 steps, the learned
     pos_embed resized) and Flux-dev at full depth (rf_sample at
     gen_fast), ms a step and peak memory, no kernel launched; one
     full-width block of each family (Swin stage 3, DiT, Flux double
     and single) and the six SMOKE configs (forward, loss, sampler)
     on the card and on the CPU within stated tolerances;
  8f. drive the training substrate (PR 22), counters set to 0 just
     before and read just after each call, none of which may launch a
     kernel (the losses run the plain attention): stablelm-3b at full
     width and depth in bf16 with remat, make_train_step(AdamW, 4
     microbatches, donated state), 3 steps at global batch 8 x 2048
     (loss and grad_norm finite, moments float32 after step 1, every
     leaf but the norm scales moved; ms a step, tokens/s, peak memory,
     one microbatch's gradients and the update timed apart); at full
     width, depth 2, float32: remat on vs off gradients, 4 microbatches
     vs 1 within the CPU tests' tolerances; ViT-B/16 at full width, bf16,
     Adafactor, 3 steps at batch 128 (ms a step, images/s, peak memory);
     `python -m repro_torch.launch.train --arch vit-b16 --steps 6` as a
     subprocess, its checkpoint restored (paths and dtypes as pinned)
     and saved again byte-equal, then `--steps 10` resuming from it; one
     AdamW step of every SMOKE config (float32 and bf16) card vs CPU
     (tests/torch_train_inputs.py `check_step`);
  8g. drive the sharding paths (PR 23), counters set to 0 just before
     and read just after each: the main path's cell with
     ShardSpec("debug") on a one-rank NCCL mesh (the four main-path
     kernels once per step, chosen, frames_sent, accuracy and pred_acc
     bit-equal to phase 5's unsharded run); the same fleet split over
     two spawned processes sharing the card in a gloo group over a file
     store (32 cameras each; the kernels once per step in each; the
     gathered decisions equal to phase 5's, pred_acc and accuracy
     within 1e-5); stablelm-3b's 32 layers in bf16 through
     make_pipelined_forward (S = 1, 4 microbatches of [1, 2048],
     dense_block with flash: 128 launches, each output bit-equal to the
     layers in sequence); ring_reduce_attend at stablelm-3b's decode
     shape against the plain full attention (float32 within 1e-5, bf16
     within one ulp), psum_scatter_grads and ring_allgather identities
     at one rank; stablelm-3b's bf16 parameters laid out by
     param_shardings, saved, restored and laid out again bit-equal
     (bytes and seconds); crosspod_allreduce_compressed over ViT-B/16's
     float32 gradients (the dequantized gradient, within half a
     quantization step of the exact one);
  8h. drive the launchers in a subprocess of its own
     (`chip_smoke.py --phase-8h`, alone: `tools/launch_phase.py`; its
     "fake" process group must not meet 8g's): dry runs
     (`repro_torch.launch.dryrun.run_cell`) of stablelm-3b decode_32k
     and vit-b16 serve_b128 on the fake (16, 16) mesh with fake tensors
     on the card, their JSON printed; then build_cell's fn for vit-b16
     serve_b128, dit-l2 gen_fast and vit-b16 cls_384 on a one-rank NCCL
     mesh with numpy-drawn weights, counters set to 0 just before and
     read just after (no kernel: the cells run impl="xla"):
     FlopCounterMode's count of each real run equal to the dry run's on
     a 1 x 1 mesh, outputs finite; ms on DTensors and on plain tensors,
     achieved TFLOP/s, torch.cuda.max_memory_allocated beside the dry
     run's bytes_per_device;
  9. print one JSON line describing every kernel (its launches on the
     detector main path; with `serve_launches` its launches on each
     path of phase 8b, for the search kernels `tables_graph_ms`,
     with `slice_launches` its launches on each path of phase 8c, and
     for flash_attention `lm_launches` and `lm_rows` from phase 8d
     and `zoo_launches` and `zoo_rows` from phase 8e, its
     `train_launches` on each train path of phase 8f, its
     `shard_launches` on each path of phase 8g and its
     `launch_launches` on each real run of phase 8h),
     the card line again, and as the last line {"ok": true, "device":
     {...}}.

In every phase, threefry's launches must equal the draws of
scene/prng.py made on the card (counted by wrapping its public draws):
no draw on the card runs the plain version. dense launches once per
float32 linear without gradients of at least layers.DENSE_MIN_ROWS rows
and layers.DENSE_MIN_MACS multiply-adds: the main path and
stablelm-3b's float32 phase check that count exactly; the other phases'
"and no other" checks read the other kernels.

Imports torch, the port (src/repro_torch), tests/torch_zoo_weights.py
(numpy-drawn zoo weights), tests/torch_train_inputs.py (numpy-drawn
train-step inputs and their comparison) and tests/torch_dist.py (the
spawned gloo ranks of phase 8g) only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import (  # noqa: E402
    LM_ARCHS,
    ShapeSpec,
    get_config,
    get_shape,
    get_smoke_config,
)
from repro_torch.core import DEFAULT_GRID, OrientationGrid  # noqa: E402
from repro_torch.core.tradeoff import BudgetConfig  # noqa: E402
from repro_torch.data import SceneConfig, build_video  # noqa: E402
from repro_torch.distributed.collectives import (  # noqa: E402
    psum_scatter_grads,
    ring_allgather,
    ring_reduce_attend,
)
from repro_torch.distributed.pipeline import (  # noqa: E402
    make_pipelined_forward,
    split_stages,
)
from repro_torch.distributed.sharding import param_shardings  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    tree_leaves as tree_leaves_nt,
    tree_map_with_path,
)
from repro_torch.fleet.api import (  # noqa: E402
    FleetRunSpec,
    ShardSpec,
    prepare_fleet_run,
    run_fleet,
)
from repro_torch.fleet.state import (  # noqa: E402
    fleet_config,
    fleet_statics,
    workload_spec,
)
from repro_torch.fleet import api as api_module  # noqa: E402
from repro_torch.fleet import runner as runner_module  # noqa: E402
from repro_torch.fleet import step as step_module  # noqa: E402
from repro_torch.fleet.runner import (  # noqa: E402
    make_scene_provider,
    materialize_scene_tables,
    run_fleet_episode,
)
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.box_iou.ops import (  # noqa: E402
    box_iou,
    box_iou_plain,
    match_boxes,
    nms_mask,
)
from repro_torch.kernels.cell_rasterize.ops import (  # noqa: E402
    cell_rasterize,
    cell_rasterize_plain,
)
from repro_torch.kernels.crop_patchify import (  # noqa: E402
    ops as patchify_module,
)
from repro_torch.kernels.dense.ops import dense, dense_plain  # noqa: E402
from repro_torch.kernels.crop_patchify.ops import (  # noqa: E402
    crop_patchify_batch,
    crop_patchify_plain,
)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention,
    flash_attention_plain,
)
from repro_torch.kernels.frame_delta.ops import (  # noqa: E402
    frame_delta,
    frame_delta_plain,
    frame_delta_tiles,
)
from repro_torch.kernels.neighbor_score.ops import (  # noqa: E402
    neighbor_score_batch,
    neighbor_score_plain,
)
from repro_torch.kernels.oracle_pass.ops import (  # noqa: E402
    oracle_pass,
    oracle_pass_plain,
)
from repro_torch.kernels.rmsnorm.ops import (  # noqa: E402
    rmsnorm,
    rmsnorm_plain,
)
from repro_torch.kernels.shape_search.ops import (  # noqa: E402
    budget_walk_batch,
    budget_walk_plain,
    shape_search_batch,
    shape_search_plain,
)
from repro_torch.launch import serve as serve_module  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.steps import build_cell  # noqa: E402
from repro_torch.learn.spec import DistillSpec  # noqa: E402
from repro_torch.core import continual  # noqa: E402
from repro_torch.core.distill import teacher_labels  # noqa: E402
from repro_torch.models import detector as detector_module  # noqa: E402
from repro_torch.models import moe as moe_module  # noqa: E402
from repro_torch.models.kvcache import (  # noqa: E402
    gqa_decode_step,
    gqa_prefill,
    init_gqa_cache,
    init_mla_cache,
    mla_decode_step,
    mla_prefill,
    moe_gqa_decode_step,
    moe_gqa_prefill,
)
from repro_torch.models.layers import (  # noqa: E402
    cast_floats,
    count_params,
    full_float32,
    layer_params,
    params_from_numpy,
)
from repro_torch.models.moe_lm import moe_lm_forward, moe_lm_init  # noqa: E402
from repro_torch.models import diffusion as diffusion_module  # noqa: E402
from repro_torch.models import dit as dit_module  # noqa: E402
from repro_torch.models import mmdit as mmdit_module  # noqa: E402
from repro_torch.models import swin as swin_module  # noqa: E402
from repro_torch.models import vit as vit_module  # noqa: E402
from repro_torch.scene import prng  # noqa: E402
from repro_torch.models.transformer import lm_forward, lm_init  # noqa: E402
from repro_torch.models.detector import (  # noqa: E402
    _decode_detections,
    detector_init,
    detector_raw,
    head_outputs,
    neck_features,
)
from repro_torch.obs.metrics import (  # noqa: E402
    MetricsSpec,
    median_valid_rank,
)
from repro_torch.models.vit import vit_features_tokens  # noqa: E402
from repro_torch.obs.events import read_events  # noqa: E402
from repro_torch.obs.trace import tracing  # noqa: E402
from repro_torch.scene import observe as observe_module  # noqa: E402
from repro_torch.scene.observe import (  # noqa: E402
    grid_windows,
    teacher_arrays,
)
from repro_torch.scene.render import (  # noqa: E402
    object_colors,
    render_background,
    render_fleet_crops,
    render_noise,
)
from repro_torch.scene.scene import (  # noqa: E402
    SceneSpec,
    advance_scene,
    init_scene,
    kind_mask,
    scene_fleet_params,
)
from repro_torch.serving import (  # noqa: E402
    NetworkTrace,
    detection_tables,
    workload_acc_table,
)
from repro_torch.serving.engine import (  # noqa: E402
    InferenceEngine,
    run_fleet_detector_controller,
)
from repro_torch.models import attention as attention_module  # noqa: E402
from repro_torch.models import layers as layers_module  # noqa: E402
from repro_torch.models.transformer import dense_block  # noqa: E402
from repro_torch.train import checkpoint as ckpt_module  # noqa: E402
from repro_torch.train import compression as compression_module  # noqa: E402
from repro_torch.train.elastic import reshard  # noqa: E402
from repro_torch.train import trainer as trainer_module  # noqa: E402
from repro_torch.train.optim import tree_leaves, tree_map  # noqa: E402
from repro_torch.launch.train import synthetic_batch  # noqa: E402

# numpy-drawn zoo weights in the reference's layout (tests/, numpy and the
# port only)
sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
from torch_zoo_weights import (  # noqa: E402
    numpy_weights,
    perturb_numpy,
    smoke_outputs,
)
import torch_dist  # noqa: E402
from torch_train_inputs import (  # noqa: E402
    TRAIN_ARCHS,
    check_step,
    numpy_batch,
    smoke as train_smoke,
    torch_batch,
    train_params,
)

# the main path's cell: full-width madeye-approx, one step's shapes
N_CAMERAS, N_STEPS, SHORTLIST_K = 64, 8, 18
FULL_STEPS = 3          # the full-param distill episode's depth
N_CHANNELS = 8          # 4 workload pairs, student + teacher draws
MAIN_PATH_KERNELS = ("shape_search", "budget_walk", "oracle_pass",
                     "crop_patchify")
# scene/prng.py's draws: one threefry launch each on the card; a detector
# step at stride 1 makes 16 in the scene advance (fold_in, split x 3,
# randint x 4, normal x 5, uniform x 3) and 3 in the render noise
# (fold_in x 2, normal)
DRAW_KERNEL = "threefry"
DRAWS = ("fold_in", "split", "random_bits", "uniform", "randint", "normal")
STEP_DRAWS = 16 + 3
# the card's published peaks (NVIDIA H100 SXM data sheet: HBM3 bandwidth,
# float32 outside the tensor cores, dense TF32 and bf16 on the tensor
# cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_TF32_PER_S = 495e12
PEAK_BF16_PER_S = 989e12
# 32-bit integer operations: 64 INT32 lanes an SM (Hopper white paper),
# 132 SMs at the 1.98 GHz of the float32 rate above
PEAK_INT32_PER_S = 132 * 64 * 1.98e9
# a threefry block function's integer operations: 20 rounds of add,
# rotate and xor, 5 key injections of 3 adds, the key schedule's 2 xors
# and the first 2 adds
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2 + 2
# float32 products on the tensor cores run in split TF32: three TF32
# products for each float32 one (csrc/wgmma.cuh)
SPLIT_TF32 = 3
TENSOR_CORE_KERNELS = ("crop_patchify", "flash_attention", "dense")
# the models' float32 linears on the card without gradients: one dense
# launch each (layers.linear); the ViT detector holds 6 a layer (q, k, v,
# o, up, down) in 6 layers, one forward a step
DENSE_KERNEL = "dense"
VIT_LINEARS = 36
# dense's kernel-table rows (M, K, N, act), each with a bias:
# swinb-f32-k18's stage-3 fc1 (576 crops x 196 tokens) and stage-4 fc2
# (576 x 49: the longest K), approx-f256-k18's up-projection, wq and
# down-projection (4,608 crops x 197 tokens)
DENSE_SHAPES = {"swinb stage-3 fc1": (112896, 512, 2048, "gelu"),
                "f256 up": (907776, 192, 768, "gelu"),
                "f256 wq": (907776, 192, 192, None),
                "f256 down": (907776, 768, 192, None),
                "swinb stage-4 fc2": (28224, 4096, 1024, None)}
# stablelm-3b's attention (src/repro/configs/stablelm_3b.py: 32 heads of
# 80 dims, MHA), batch 2 at a 4096-token context
STABLELM_ATTN = dict(b=2, s=4096, h=32, d=80)
N_BOX_CAMERAS = 16      # box_iou: one step's detections of 16 cameras
# the benchmark's swinb-f32-k18 cell (bench/configs/madeye-swin-b.json,
# bench/traffic/f32-k18.json): Swin-B's patch 4 and width 128 over 32
# cameras x SHORTLIST_K windows of 224 px, a 22-slot scene
SWIN_CAMERAS, SWIN_PATCH, SWIN_D = 32, 4, 128
# past the kernels' old limits: the 7.5-degree grid (200 cells, four-word
# cell sets), a 40-slot scene (two ownership words), 16 cameras
BIG_GRID = {"pan_step": 7.5, "tilt_step": 7.5}
BIG_SCENE = dict(max_people=24, max_cars=16)
BIG_CAMERAS, BIG_STEPS = 16, 3
# flash attention past 128 head dims (the MLA configs' 192-wide query /
# key heads, src/repro/configs/deepseek_v3_671b.py, and 256)
WIDE_ATTN = dict(b=2, s=1024, h=8)
# the serving launcher at its defaults (5 fps, 20 s of 15 fps video: 100
# controller steps); its detector branch over 5 steps (1 s)
SERVE = dict(fps=5.0, duration=20.0)
SERVE_STEPS = 100
SERVE_DETECTOR = dict(fps=5.0, duration=1.0, fleet=8, provider="detector",
                      shortlist_k=SHORTLIST_K, distill=True)
SEARCH_KERNELS = ("shape_search", "budget_walk")
# the unfused detector path launches the main path's kernels but
# crop_patchify (it renders pixels and embeds them with a matmul)
UNFUSED_KERNELS = ("shape_search", "budget_walk", "oracle_pass")
# a detection within this of a decision boundary (a score threshold, the
# top-k cut, a class tie) may fall on either side under float32
# round-off in another order
NEAR_BAND = 1e-4
# windows with a detection within NEAR_BAND of a score threshold, and
# windows that differ between two formulations of the detector (each
# must hold a detection near a boundary), each at most this share of all
NEAR_SHARE = 1e-3
# the anchor's weights: drawn by numpy (np.random.default_rng), so the
# card runs the same net under any PyTorch as the CPU does, at the
# threshold of fresh weights
ANCHOR_SEED, FRESH_THRESH = 0, 0.3
ENGINE_CAMERAS, ENGINE_STEPS = 8, 3
FINETUNE_STEPS = 3
# the port's examples as `python -m repro_torch.examples.<name>`, with the
# small REPRO_EX_* overrides of the CPU smoke test, and their result lines
EXAMPLES = (
    ("fleet_experiment", {"REPRO_EX_CAMERAS": "8", "REPRO_EX_STEPS": "3"},
     "fleet accuracy"),
    ("adaptive_serving", {"REPRO_EX_DURATION": "2.0",
                          "REPRO_EX_STEPS": "3"},
     "NN-in-the-loop MadEye accuracy"),
    ("continual_distillation", {"REPRO_EX_DURATION": "2.0",
                                "REPRO_EX_EVALS": "4"},
     "replay: rank quality"),
)
# the LM half of the model zoo (PR 20): stablelm-3b at full width and
# depth (src/repro/configs/stablelm_3b.py:8), 4 requests of 2048 prompt
# tokens and 16 continuation tokens; deepseek-v3 at full width
# (src/repro/configs/deepseek_v3_671b.py:8), depth cut to its 3 dense
# layers and 1 MoE layer (the 61-layer model does not fit one card),
# 2 x 512 tokens, the last 8 decoded; weights from seeded CUDA
# generators (compared only with other runs on the card)
LM_DENSE_ARCH, LM_BATCH, LM_PROMPT, LM_CONT = "stablelm-3b", 4, 2048, 16
# its linears a layer (q, k, v, o; the MLP's gate, up, down), besides
# the head
LM_LINEARS = 7
LM_MOE_ARCH, LM_MOE_LAYERS = "deepseek-v3-671b", 4
LM_MOE_BATCH, LM_MOE_SEQ, LM_MOE_DECODE = 2, 512, 8
LM_SEED = 0
LM_SMALL_PROMPT = 8     # smoke configs: 8 prompt tokens, 4 decoded
# float32 flash vs xla (and prefill vs forward): the flash kernel's
# stated float32 tolerance, 3e-5 on outputs of order 1, scaled to the
# logits' largest magnitude
LM_F32_REL = 3e-5
# decode of a float32 model from its bf16 cache vs the forward: the
# reference's own tolerance for that comparison
# (tests/test_models_smoke.py:68-77)
LM_DECODE_TOL = 2e-2
# bf16 logits of magnitude 2-4 (bf16 spacing 2^-7 to 2^-6) from two
# formulations, each rounding every op: a handful of ulps through 4
# layers and a 7168-long head product, at most ~16 ulps
LM_BF16_ABS = 0.25
LM_SMALL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LM_TIE_GAP = 1e-6
# the vision and diffusion half of the model zoo, full width and
# depth (src/repro/configs/{vit_h14,vit_b16,vit_s16,swin_b,dit_l2,
# flux_dev}.py), weights from seeded CUDA generators; the ViTs at
# serve_b128 (224 px, batch 128) in bf16 with impl="flash" and "xla" and
# a float32 flash vs xla check at batch 8; Swin-B at serve_b128 and one
# cls_384 forward (windows 12) at batch 8; DiT-L/2 and Flux-dev sampled at
# gen_fast (512 px: latent 64, batch 16, 4 steps)
ZOO_VITS = ("vit-h14", "vit-b16", "vit-s16")
ZOO_SEED = 0
ZOO_SERVE_BATCH, ZOO_F32_BATCH, ZOO_384_BATCH = 128, 8, 8
ZOO_GEN_RES, ZOO_GEN_BATCH, ZOO_GEN_STEPS = 512, 16, 4
ZOO_DIT_F32_BATCH = 2                # DiT float32 vs bf16 at 256 px
# zero-initialised adaLN linears and final projections are drawn at this
# std (a trained model's are not zero; at zero every block is the
# identity and the output 0)
ZOO_WAKE_STD = 0.02
# sanity bounds on two bf16 formulations' relative RMS (ViT flash vs
# xla logits; DiT-L/2 bf16 vs float32): 24-32 layers of bf16 rounding
# (2^-9 per op) random-walk to ~1e-2; a wrong path is off by O(1)
ZOO_BF16_REL_RMS = 0.1
ZOO_PEAK_GIB = 70.0                  # Flux runs at full depth below this
# full-width blocks and SMOKE configs, card vs CPU: max |card - CPU| over
# max(1, max |CPU|) (the CPU tests' tolerances against the reference)
ZOO_CPU_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ZOO_BLOCK_TOKENS = 256               # DiT / MMDiT image tokens of the block check
# the training substrate (PR 22): stablelm-3b at full width and depth
# (src/repro/configs/stablelm_3b.py:8) in bf16 with remat, AdamW, 3 steps
# at global batch 8 x 2048 tokens in 4 microbatches (train_4k's 256 x
# 4096 cut to fit one card); its float32 checks at full width, depth cut
# to 2 layers, batch 4 x 2048; ViT-B/16 (src/repro/configs/vit_b16.py:4)
# at batch 128, 224 px, bf16, Adafactor, 3 steps; the launcher on
# ViT-B/16 at batch 8 (6 steps, then resumed to 10); one step of each
# SMOKE config, card vs CPU (tests/torch_train_inputs.py)
TRAIN_LM_ARCH, TRAIN_LM_BATCH, TRAIN_LM_SEQ = "stablelm-3b", 8, 2048
TRAIN_LM_MICRO, TRAIN_STEPS = 4, 3
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH = 2, 4
TRAIN_VIT_ARCH, TRAIN_VIT_BATCH = "vit-b16", 128
TRAIN_LAUNCH_STEPS = (6, 10)
TRAIN_SEED = 0
# remat on vs off: the same kernels on the same inputs (bit-equal
# expected); held to 1e-6 of each gradient leaf's largest in case a
# library picks another algorithm for the recomputed graph
TRAIN_REMAT_REL = 1e-6
# the launchers: dry runs on the fake (16, 16) mesh with fake
# tensors on the card; real runs of build_cell's fn on a one-rank NCCL
# mesh, numpy weights, beside the dry run on a 1 x 1 mesh
LAUNCH_DRY_CELLS = [("stablelm-3b", "decode_32k"), ("vit-b16", "serve_b128")]
LAUNCH_REAL_CELLS = [("vit-b16", "serve_b128"), ("dit-l2", "gen_fast"),
                     ("vit-b16", "cls_384")]
LAUNCH_SEED = 24
# a one-rank mesh's DTensor run against the plain tensors' run of the
# same cell: the products see other shapes (rows flattened, per-shard
# attention), so cuBLAS may sum in another order; bf16 outputs are held
# to 4 bf16 ulps of their largest magnitude, a train step to
# tests/torch_train_inputs.py check_step's bf16 tolerances
LAUNCH_REL_TOL = 2.0 ** -6
LAUNCH_TIMEOUT_S = 300
FRAME = (1080, 1920, 3)  # frame_delta: one 1080p RGB frame per camera
RMS_SHAPE = (8, 4096, 2560)  # rmsnorm at stablelm-3b's d_model

SOURCES = {
    # the shape search's loops fused around the neighbor score; the TPU
    # kernel it replaces on the main path is neighbor_score's
    "shape_search": (
        "src/repro_torch/csrc/shape_search.cu",
        "src/repro/kernels/neighbor_score/neighbor_score.py:47"),
    # the reference's shrink-to-budget is an XLA while loop, no Pallas
    "budget_walk": (
        "src/repro_torch/csrc/shape_search.cu",
        "src/repro/fleet/step.py:207"),
    "neighbor_score": (
        "src/repro_torch/csrc/neighbor_score.cu",
        "src/repro/kernels/neighbor_score/neighbor_score.py:47"),
    "cell_rasterize": (
        "src/repro_torch/csrc/cell_rasterize.cu",
        "src/repro/kernels/cell_rasterize/cell_rasterize.py:89"),
    # the whole oracle pass around the rasterization; the TPU kernel it
    # replaces on the main path is cell_rasterize's
    "oracle_pass": (
        "src/repro_torch/csrc/oracle_pass.cu",
        "src/repro/kernels/cell_rasterize/cell_rasterize.py:89"),
    "crop_patchify": (
        "src/repro_torch/csrc/crop_patchify.cu",
        "src/repro/kernels/crop_patchify/crop_patchify.py:95"),
    "flash_attention": (
        "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/flash_attention.py:104"),
    "box_iou": (
        "src/repro_torch/csrc/box_iou.cu",
        "src/repro/kernels/box_iou/box_iou.py:49"),
    "frame_delta": (
        "src/repro_torch/csrc/frame_delta.cu",
        "src/repro/kernels/frame_delta/frame_delta.py:36"),
    "rmsnorm": (
        "src/repro_torch/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm/rmsnorm.py:27"),
    # the reference draws through jax.random, whose threefry XLA fuses
    "threefry": (
        "src/repro_torch/csrc/threefry.cu",
        "none: jax.random's threefry (src/repro/scene/scene.py, "
        "src/repro/scene/render.py)"),
    # the reference's linears are dots XLA compiles
    "dense": (
        "src/repro_torch/csrc/dense.cu",
        "none: the models' dots, left to XLA (src/repro/models/"
        "layers.py linear)"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` back-to-back calls, after a
    warm-up, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time of fn() per call with no host cost between calls: one
    CUDA graph of `iters` back-to-back calls, captured after a warm-up
    and replayed once warm, timed by CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def check_close(name, got, want, atol, rtol=0.0):
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"{name}[{i}]: shape {tuple(g.shape)} != "
                                 f"{tuple(w.shape)}")
        bad = (g - w).abs() > atol + rtol * w.abs()
        if bool(bad.any()) or not bool(torch.isfinite(g).all()):
            raise AssertionError(
                f"{name}[{i}]: {int(bad.sum())} elements off by more than "
                f"atol={atol} rtol={rtol} (max abs err "
                f"{float((g - w).abs().max())})")


def bound(n_bytes: float, n_ops: float,
          peak_ops: float = PEAK_FP32_PER_S) -> tuple[float, str, str]:
    """(least ms, "bytes" or "operations", the rate it was taken at)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / peak_ops * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", "3.35 TB/s"
    rate = {PEAK_FP32_PER_S: "FP32 67 TFLOP/s",
            PEAK_TF32_PER_S: "3xTF32 at 495 TFLOP/s",
            PEAK_BF16_PER_S: "bf16 989 TFLOP/s",
            PEAK_INT32_PER_S: "INT32 16.7 Top/s"}[peak_ops]
    return t_ops, "operations", rate


def split_tf32_bound(n_bytes: float, n_flop: float) -> tuple[float, str,
                                                              str]:
    """The bound of a float32 product run in split TF32: three TF32
    operations for each float32 one, at the dense TF32 rate."""
    return bound(n_bytes, SPLIT_TF32 * n_flop, PEAK_TF32_PER_S)


def sass_mma_counts(path) -> dict:
    """Tensor-core instructions (HGMMA, HMMA) per kernel in the built
    library's SASS, by cuobjdump; {} where the toolkit has none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1]
            name = next((k for k in SOURCES if f"{k}_kernel" in fn), fn)
            counts.setdefault(name, {"HGMMA": 0, "HMMA": 0})
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if f" {op}." in line:
                    counts[name][op] += 1
    return counts


def main_path_inputs(dev):
    """One step's inputs at the main path's shapes, from a scene of
    N_CAMERAS cameras advanced a few frames (seeded)."""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape):
        return torch.rand(shape, generator=gen).to(dev)

    spec = SceneSpec()
    params, rng = scene_fleet_params(spec, N_CAMERAS, device=dev)
    sc = init_scene(spec, params, rng)
    sc = advance_scene(spec, params, rng, sc, 2, 4)
    grid = DEFAULT_GRID
    statics = fleet_statics(grid, dev)
    windows = grid_windows(grid, device=dev)
    n, c = grid.n_cells, windows.shape[0]
    m = spec.max_objects
    strips = [x.contiguous() for x in (sc.pos[..., 0], sc.pos[..., 1],
                                       sc.size[..., 0], sc.size[..., 1])]

    member_has = (rand(N_CAMERAS, n) < 0.4).float()
    cent = statics.centers[None] + 10.0 * (rand(N_CAMERAS, n, 2) - 0.5)
    ns_args = (member_has, cent[..., 0].contiguous(),
               cent[..., 1].contiguous(), statics.d_center,
               statics.overlap, statics.cell_x, statics.cell_y)

    draw = torch.where(rand(N_CAMERAS, N_CHANNELS, m) < 0.2, 2.0,
                       1.2 * rand(N_CAMERAS, N_CHANNELS, m))
    a0 = 0.05 + 0.05 * rand(N_CHANNELS)
    a1 = a0 + 0.1 + 0.1 * rand(N_CHANNELS)
    cr_args = (*strips, draw, a0, a1, windows)

    cfg = get_config("madeye-approx")
    cp_args, cp_kw = patchify_args(dev, gen, spec, sc, rng, strips,
                                   windows, cfg.img_res, cfg.patch,
                                   cfg.d_model)
    return (ns_args, (cr_args, dict(min_visible=spec.min_visible,
                                    n_moment=N_CHANNELS // 2)),
            (cp_args, cp_kw))


def patchify_args(dev, gen, spec, sc, rng, strips, windows, res: int,
                  patch: int, d: int):
    """crop_patchify's arguments and keywords: SHORTLIST_K windows of a
    random order a camera, the scene `sc` (its object `strips`), the
    background with noise, a He-scaled patch embed of width d (drawn
    from `gen`)."""
    f = strips[0].shape[0]
    widx = torch.argsort(torch.rand((f, windows.shape[0]),
                                    generator=gen).to(dev),
                         dim=-1)[:, :SHORTLIST_K]
    wins = windows[widx].contiguous()                       # [F, K, 4]
    kinds = torch.as_tensor(kind_mask(spec), device=dev)
    colors = object_colors(kinds, sc.oid).contiguous()
    bgn = (render_background(res, dev)[None]
           + 0.05 * render_noise(rng, 2, res)).contiguous()
    depth = patch * patch * 3
    wflat = (math.sqrt(2.0 / depth)
             * torch.randn((depth, d), generator=gen)).to(dev)
    bias = (0.01 * torch.randn(d, generator=gen)).to(dev)
    return ((*strips, colors, wins, bgn, wflat, bias),
            dict(res=res, patch=patch, min_visible=spec.min_visible))


def swin_patchify_inputs(dev):
    """crop_patchify's arguments at the swinb-f32-k18 cell's shapes:
    SWIN_CAMERAS cameras' scene advanced a few frames (seeded)."""
    gen = torch.Generator(device="cpu").manual_seed(1)
    spec = SceneSpec()
    params, rng = scene_fleet_params(spec, SWIN_CAMERAS, device=dev)
    sc = advance_scene(spec, params, rng, init_scene(spec, params, rng),
                       2, 4)
    strips = [x.contiguous() for x in (sc.pos[..., 0], sc.pos[..., 1],
                                       sc.size[..., 0], sc.size[..., 1])]
    return patchify_args(dev, gen, spec, sc, rng, strips,
                         grid_windows(DEFAULT_GRID, device=dev),
                         get_config("madeye-approx").img_res, SWIN_PATCH,
                         SWIN_D)


def kernel_phase(dev) -> dict:
    """Each kernel against its plain version at the main path's shapes,
    with tolerances and reasons; both timed. Returns per-kernel rows."""
    ns_args, (cr_args, cr_kw), (cp_args, cp_kw) = main_path_inputs(dev)
    rows = {}

    # neighbor_score: same formula, the member sum in another order
    # (f32 round-off only) -> 1e-5 relative
    got = (neighbor_score_batch(*ns_args),)
    want = (neighbor_score_plain(*ns_args),)
    torch.cuda.synchronize()
    check_close("neighbor_score", got, want, atol=1e-5, rtol=1e-5)
    b, n = ns_args[0].shape
    n_bytes = 4 * (3 * b * n + 2 * n * n + 2 * n + b * n)
    rows["neighbor_score"] = dict(
        max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: neighbor_score_batch(*ns_args), 200),
        graph_ms=graph_ms(lambda: neighbor_score_batch(*ns_args), 200),
        plain_ms=cuda_ms(lambda: neighbor_score_plain(*ns_args), 200),
        bound=bound(n_bytes, 12 * b * n * n))

    # cell_rasterize: counts are exact integers and must agree exactly;
    # areas and moments are f32 sums over objects in another order ->
    # 1e-5 absolute + 1e-5 relative (the moments reach ~1e6 deg^2)
    got = cell_rasterize(*cr_args, **cr_kw)
    want = cell_rasterize_plain(*cr_args, **cr_kw)
    torch.cuda.synchronize()
    check_close("cell_rasterize.cnt", got[:1], want[:1], atol=0.0)
    check_close("cell_rasterize", got[1:], want[1:], atol=1e-5, rtol=1e-5)
    f, m = cr_args[0].shape
    p = cr_args[4].shape[1]
    c = cr_args[7].shape[0]
    n_bytes = 4 * (4 * f * m + f * p * m + 2 * p + 4 * c
                   + 2 * f * p * c + 4 * f * c)
    # per (camera, object, window): ~25 geometry ops + ~6 per channel
    rows["cell_rasterize"] = dict(
        max_abs_err=max_err(got[1:], want[1:]),
        ms=cuda_ms(lambda: cell_rasterize(*cr_args, **cr_kw), 200),
        graph_ms=graph_ms(lambda: cell_rasterize(*cr_args, **cr_kw), 200),
        plain_ms=cuda_ms(lambda: cell_rasterize_plain(*cr_args, **cr_kw),
                         50),
        bound=bound(n_bytes, f * m * c * (25 + 6 * p)))

    # crop_patchify: identical pixels, the 768-term token product in split
    # TF32 on the tensor cores (~2^-22 relative per term) against
    # torch.matmul's float32 -> 1e-4 absolute on tokens of order 1
    got = (crop_patchify_batch(*cp_args, **cp_kw),)
    want = (crop_patchify_plain(*cp_args, **cp_kw),)
    torch.cuda.synchronize()
    check_close("crop_patchify", got, want, atol=1e-4)
    rows["crop_patchify"] = dict(
        max_abs_err=max_err(got, want),
        ms=cuda_ms(lambda: crop_patchify_batch(*cp_args, **cp_kw), 10),
        plain_ms=cuda_ms(lambda: crop_patchify_plain(*cp_args, **cp_kw),
                         5),
        bound=patchify_bound(cp_args, cp_kw))
    for name, r in rows.items():
        print_row(name, r)

    # crop_patchify at the swinb-f32-k18 cell's shape: 3,136 tokens a
    # crop over 48-deep patches (one K chunk, ragged row tiles), the same
    # product and tolerance as at patch 16; one launch and no other
    sw_args, sw_kw = swin_patchify_inputs(dev)
    torch.cuda.synchronize()
    _lib.reset_launch_counts()
    got = (crop_patchify_batch(*sw_args, **sw_kw),)
    launched = {k: v for k, v in _lib.launch_counts().items() if v}
    if launched != {"crop_patchify": 1}:
        raise AssertionError(f"crop_patchify [swin-b]: launched {launched}")
    want = (crop_patchify_plain(*sw_args, **sw_kw),)
    torch.cuda.synchronize()
    check_close("crop_patchify [swin-b]", got, want, atol=1e-4)
    row = dict(
        max_abs_err=max_err(got, want), launches=1,
        ms=cuda_ms(lambda: crop_patchify_batch(*sw_args, **sw_kw), 10),
        plain_ms=cuda_ms(lambda: crop_patchify_plain(*sw_args, **sw_kw),
                         3),
        bound=patchify_bound(sw_args, sw_kw))
    del got, want
    f, k = sw_args[5].shape[:2]
    print_row(f"crop_patchify [swinb-f32-k18: {f} x {k} crops, patch "
              f"{SWIN_PATCH}, D {SWIN_D}]", row)
    rows["crop_patchify"]["swin_b"] = row
    return rows


def _bits_equal(name: str, got: torch.Tensor, want: torch.Tensor) -> None:
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: not bit-equal to the plain version")


def threefry_phase(dev) -> dict:
    """threefry against scene/prng.py's plain version, bit-equal, at the
    main path's shapes: every draw of a scene step (64 cameras, 22 slots;
    keys sliced from split(keys, 8) as _spawn_draws takes them) and the
    render noise [64, 224, 224, 3]; the noise draw and one scene draw
    timed beside their bounds (bytes written once against the block
    function's integer operations). The scene draws take less device
    time than a Python call takes to dispatch, so their graph_ms is
    the device's time."""
    m = SceneSpec().max_objects
    keys = prng.fold_in_plain(prng.PRNGKey(7, dev),
                              torch.arange(N_CAMERAS, device=dev))
    ks = prng.split_plain(keys, 8)
    step = torch.full((N_CAMERAS,), 5, dtype=torch.int64, device=dev)
    cases = [
        ("fold_in", prng.fold_in, prng.fold_in_plain, (keys, step)),
        ("split", prng.split, prng.split_plain, (keys, 4)),
        ("randint", prng.randint, prng.randint_plain,
         (ks[:, 0], (m,), 0, 10)),
        ("normal", prng.normal, prng.normal_plain, (ks[:, 1], (m, 2))),
        ("uniform", prng.uniform, prng.uniform_plain,
         (ks[:, 4], (m,), 1.1, 1.9)),
        ("uniform", prng.uniform, prng.uniform_plain, (ks[:, 6], (m, 4))),
    ]
    for name, fn, plain, args in cases:
        _bits_equal(f"threefry {name}", fn(*args), plain(*args))
    res = get_config("madeye-approx").img_res
    shape = (res, res, 3)
    got, want = prng.normal(keys, shape), prng.normal_plain(keys, shape)
    _bits_equal("threefry normal (noise)", got, want)
    n = got.numel()
    del got, want
    print(f"threefry: bit-equal to the plain version on the scene step's "
          f"draws ({len(cases)} calls at {N_CAMERAS} cameras x {m} slots) "
          f"and the render noise ({n} samples)", flush=True)
    rows = {"threefry": dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: prng.normal(keys, shape), 50),
        graph_ms=graph_ms(lambda: prng.normal(keys, shape), 20),
        plain_ms=cuda_ms(lambda: prng.normal_plain(keys, shape), 5),
        bound=bound(4 * n + 16 * N_CAMERAS, THREEFRY_OPS * n,
                    PEAK_INT32_PER_S), library_ms=None)}
    print_row(f"threefry [normal {N_CAMERAS} x {res} x {res} x 3]",
              rows["threefry"])
    scene = (ks[:, 1], (m, 2))
    row = dict(max_abs_err=0.0, ms=cuda_ms(lambda: prng.normal(*scene), 200),
               graph_ms=graph_ms(lambda: prng.normal(*scene), 200),
               plain_ms=cuda_ms(lambda: prng.normal_plain(*scene), 50),
               bound=bound(4 * N_CAMERAS * m * 2 + 16 * N_CAMERAS,
                           THREEFRY_OPS * N_CAMERAS * m * 2,
                           PEAK_INT32_PER_S), library_ms=None)
    print_row(f"threefry [scene normal {N_CAMERAS} x {m} x 2]", row)
    return rows


def patchify_bound(cp_args, cp_kw) -> tuple[float, str, str]:
    """crop_patchify's bound on its arguments: the object strips,
    colours, windows, plane and weights read once and the tokens written
    once, against the split-TF32 product."""
    f, m = cp_args[0].shape
    k = cp_args[5].shape[-2]
    res, patch = cp_kw["res"], cp_kw["patch"]
    depth, d = cp_args[7].shape
    gg = (res // patch) ** 2
    n_bytes = 4 * (4 * f * m + 3 * f * m + f * k * 4 + f * res * res * 3
                   + depth * d + d + f * k * gg * d)
    return split_tf32_bound(n_bytes, 2.0 * f * k * gg * depth * d)


def print_row(name: str, r: dict) -> None:
    lib = r.get("library_ms")
    graph = (f" graph_ms={r['graph_ms']:.6f}" if "graph_ms" in r else "")
    print(f"kernel {name}: max_abs_err={r['max_abs_err']:.3e} "
          f"ms={r['ms']:.6f}{graph} plain_ms={r['plain_ms']:.6f} "
          f"bound_ms={r['bound'][0]:.6f} ({r['bound'][1]}, "
          f"{r['bound'][2]}) library_ms="
          + ("null" if lib is None else f"{lib:.6f}"), flush=True)


def attn_pairs(sq: int, sk: int, causal: bool, q_offset: int) -> int:
    """Unmasked (query, key) pairs: what the kernel's work depends on."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i + q_offset + 1)) for i in range(sq))


def flash_case(dev, b, sq, sk, hq, hkv, d, *, causal=False, q_offset=0,
               dtype=torch.float32, iters=10, plain_iters=3,
               library=False) -> dict:
    """flash_attention against its plain version on seeded N(0, 1)
    inputs (logits of unit scale), timed beside its bound."""
    gen = torch.Generator(device=dev).manual_seed(sq * 131 + d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                             (b, sk, hkv, d)))
    kw = dict(causal=causal, q_offset=q_offset)
    got = flash_attention(q, k, v, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    # float32: split-TF32 products (~2^-22 relative per term) and the
    # online softmax summed in another order (3e-5 on outputs of order
    # 1); bf16: P and the output rounded to bf16 (2e-2)
    tol = 2e-2 if dtype == torch.bfloat16 else 3e-5
    name = (f"flash_attention[{b}x{sq}x{hq}x{d} kv {sk}x{hkv} "
            f"causal={causal} q_offset={q_offset} {str(dtype)[6:]}]")
    check_close(name, (got.float(),), (want.float(),), atol=tol, rtol=tol)
    es = q.element_size()
    n_bytes = es * (2 * b * sq * hq * d + 2 * b * sk * hkv * d)
    n_ops = 4.0 * b * hq * attn_pairs(sq, sk, causal, q_offset) * d
    lim = (bound(n_bytes, n_ops, PEAK_BF16_PER_S) if dtype == torch.bfloat16
           else split_tf32_bound(n_bytes, n_ops))
    row = dict(max_abs_err=float((got.float() - want.float()).abs().max()),
               ms=cuda_ms(lambda: flash_attention(q, k, v, **kw), iters),
               plain_ms=cuda_ms(lambda: flash_attention_plain(q, k, v, **kw),
                                plain_iters),
               bound=lim, library_ms=None)
    del got, want
    if library:
        # PyTorch's own fused attention on the same inputs in [B, H, S, D]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        row["library_ms"] = cuda_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal), iters)
    print_row(name, row)
    return row


def delta_frames(n: int, dev, seed: int):
    """n (cur, prev) frame pairs [n, *FRAME]: each 16 x 128 tile moves by
    N(0, sigma) noise with sigma 0.002 (still), 0.025 (at tau's edge) or
    0.05 (moving)."""
    h, w, c = FRAME
    gen = torch.Generator(device=dev).manual_seed(seed)
    prev = torch.rand((n, h, w, c), generator=gen, device=dev)
    sig = torch.tensor([0.002, 0.025, 0.05], device=dev)[torch.randint(
        0, 3, (n, -(-h // 16), -(-w // 128)), generator=gen, device=dev)]
    sig = sig.repeat_interleave(16, 1)[:, :h]
    sig = sig.repeat_interleave(128, 2)[..., :w]
    cur = prev + sig[..., None] * torch.randn((n, h, w, c), generator=gen,
                                              device=dev)
    return cur, prev


def check_frame_delta(cur, prev, dq, changed, name) -> tuple[int, int]:
    """changed equal except on tiles whose plain mean lies within 1e-6 of
    tau (a sum in another order may flip them); int8 residuals equal
    wherever both sides agree on the tile. Returns (max |int8 difference|
    over the whole frame, tiles flipped)."""
    h, w, c = cur.shape
    dq_p, changed_p = frame_delta_plain(cur, prev)
    d = F.pad(cur - prev, (0, 0, 0, (-w) % 128, 0, (-h) % 16))
    mean = d.abs().reshape(d.shape[0] // 16, 16, d.shape[1] // 128, 128,
                           c).mean(dim=(1, 3, 4))
    agree = changed == changed_p
    if not bool((agree | ((mean - 0.02).abs() < 1e-6)).all()):
        raise AssertionError(f"{name}: changed differs away from tau")
    px = agree.repeat_interleave(16, 0)[:h].repeat_interleave(128, 1)[:, :w]
    if not bool(((dq == dq_p) | ~px[..., None]).all()):
        raise AssertionError(f"{name}: int8 residuals differ")
    return (int((dq.int() - dq_p.int()).abs().max()),
            int((~agree).sum()))


def new_kernel_phase(dev) -> dict:
    """flash_attention, box_iou, frame_delta and rmsnorm against their
    plain versions at full-size shapes (tolerances and reasons inline),
    timed beside their bounds and, where one PyTorch call computes the
    same function, that call. Returns per-kernel rows."""
    rows = {}
    # flash_attention: the ViT's layer (64 cameras x 18 crops, 197
    # tokens, 6 heads of 32) is the row; stablelm-3b's causal width, GQA
    # with q_offset and bf16 are cases
    rows["flash_attention"] = flash_case(
        dev, N_CAMERAS * SHORTLIST_K, 197, 197, 6, 6, 32, iters=20,
        plain_iters=5, library=True)
    sl = STABLELM_ATTN
    flash_case(dev, sl["b"], sl["s"], sl["s"], sl["h"], sl["h"], sl["d"],
               causal=True, iters=5, plain_iters=2, library=True)
    flash_case(dev, 4, 100, 164, 8, 2, 64, causal=True, q_offset=64)
    flash_case(dev, 64, 256, 256, 8, 8, 64, dtype=torch.bfloat16)
    wa = WIDE_ATTN
    for d in (192, 256):
        for dtype in (torch.float32, torch.bfloat16):
            flash_case(dev, wa["b"], wa["s"], wa["s"], wa["h"], wa["h"], d,
                       causal=True, dtype=dtype, iters=10, plain_iters=2,
                       library=True)

    # box_iou: the same float32 ops in the same order (a division skipped
    # where inter == 0 is exact) -> bit-equal
    n = N_BOX_CAMERAS * SHORTLIST_K * 32
    gen = torch.Generator(device=dev).manual_seed(1)

    def boxes():
        return torch.cat([torch.rand((n, 2), generator=gen, device=dev),
                          0.02 + 0.3 * torch.rand((n, 2), generator=gen,
                                                  device=dev)], 1)

    a, b = boxes(), boxes()
    rows["box_iou"] = box_iou_row(a, b, "random boxes")

    # frame_delta on one 1080p frame
    cur, prev = (x[0] for x in delta_frames(1, dev, 2))
    dq, changed = frame_delta_tiles(cur, prev)
    torch.cuda.synchronize()
    err, flipped = check_frame_delta(cur, prev, dq, changed, "frame_delta")
    print(f"frame_delta: {flipped} of {changed.numel()} tiles flipped "
          f"(plain mean within 1e-6 of tau), max |int8 difference| {err}",
          flush=True)
    h, w, c = FRAME
    gg = changed.numel()
    rows["frame_delta"] = dict(
        max_abs_err=float(err),
        ms=cuda_ms(lambda: frame_delta_tiles(cur, prev), 100),
        graph_ms=graph_ms(lambda: frame_delta_tiles(cur, prev), 100),
        plain_ms=cuda_ms(lambda: frame_delta_plain(cur, prev), 20),
        bound=bound(h * w * c * (4 + 4 + 1) + 4 * gg, 6.0 * h * w * c),
        library_ms=None)
    print_row("frame_delta", rows["frame_delta"])

    # rmsnorm: a 2560-term sum of squares in another order and a
    # correctly rounded 1/sqrt against torch.rsqrt -> 1e-5
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(RMS_SHAPE, generator=gen, device=dev)
    wt = torch.randn(RMS_SHAPE[-1], generator=gen, device=dev) + 1.0
    got, want = rmsnorm(x, wt), rmsnorm_plain(x, wt)
    torch.cuda.synchronize()
    check_close("rmsnorm", (got,), (want,), atol=1e-5, rtol=1e-5)
    err = max_err((got,), (want,))
    del got, want
    rows["rmsnorm"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: rmsnorm(x, wt), 20),
        plain_ms=cuda_ms(lambda: rmsnorm_plain(x, wt), 10),
        bound=bound(4 * (2 * x.numel() + wt.numel()), 4.0 * x.numel()),
        library_ms=cuda_ms(lambda: F.rms_norm(x, (RMS_SHAPE[-1],), wt,
                                              eps=1e-6), 20))
    print_row("rmsnorm", rows["rmsnorm"])
    return rows


def box_iou_row(a, b, label: str) -> dict:
    """box_iou bit-equal to its plain version on a [N, 4] x [M, 4], timed
    beside its bound (the [N, M] float32 output written once); prints
    the share of pairs that intersect (a division each) and of the
    bound."""
    got, want = box_iou(a, b), box_iou_plain(a, b)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"box_iou ({label}): not bit-equal to the "
                             f"plain version (max abs err "
                             f"{max_err((got,), (want,))})")
    n, m = a.shape[0], b.shape[0]
    hit = float((got > 0).float().mean())
    del want
    # the yardstick of a store stream: a write-only pass over the output
    zero_ms = cuda_ms(got.zero_, 50)
    del got
    # ~13 operations per pair (4 min/max, 4 sub/add, 2 clamps, 1 product,
    # 1 max, 1 division)
    row = dict(max_abs_err=0.0, ms=cuda_ms(lambda: box_iou(a, b), 50),
               graph_ms=graph_ms(lambda: box_iou(a, b), 50),
               plain_ms=cuda_ms(lambda: box_iou_plain(a, b), 10),
               bound=bound(4 * (4 * n + 4 * m + n * m), 13.0 * n * m),
               library_ms=None)
    print(f"box_iou ({label}, {n} x {m}): bit-equal to the plain version; "
          f"{hit:.3f} of the pairs intersect; graph_ms at "
          f"{row['bound'][0] / row['graph_ms']:.3f} of the bound; a "
          f"write-only Tensor.zero_ of the output {zero_ms:.4f} ms",
          flush=True)
    print_row("box_iou", row)
    return row


def dense_phase(dev) -> dict:
    """dense at DENSE_SHAPES: one launch and no other, against its plain
    version (cuBLAS's float32 product, TF32 off, then the bias add and
    GELU) within 1e-4 absolute on outputs of order 1 (split TF32,
    ~2^-22 relative per term, as crop_patchify); timed beside its bound
    (the split-TF32 product at the TF32 rate, or x and w read and y
    written once), the plain version and torch.matmul + add in float32
    (the call the port no longer makes). The first shape is the row,
    the others ride beside it."""
    gen = np.random.default_rng(31)
    rows = {}
    for label, (m, k, n, act) in DENSE_SHAPES.items():
        x = torch.as_tensor(gen.normal(0, 1, (m, k)).astype(np.float32),
                            device=dev)
        w = torch.as_tensor((gen.normal(0, 1, (k, n)) / math.sqrt(k))
                            .astype(np.float32), device=dev)
        b = torch.as_tensor(gen.normal(0, 0.1, n).astype(np.float32),
                            device=dev)
        torch.cuda.synchronize()
        _lib.reset_launch_counts()
        got = (dense(x, w, b, act=act),)
        launched = {kk: v for kk, v in _lib.launch_counts().items() if v}
        if launched != {DENSE_KERNEL: 1}:
            raise AssertionError(f"dense [{label}]: launched {launched}")
        with full_float32():
            want = (dense_plain(x, w, b, act),)
            torch.cuda.synchronize()
            check_close(f"dense [{label}]", got, want, atol=1e-4)
            row = dict(
                max_abs_err=max_err(got, want), launches=1,
                ms=cuda_ms(lambda: dense(x, w, b, act=act), 10),
                graph_ms=graph_ms(lambda: dense(x, w, b, act=act), 10),
                plain_ms=cuda_ms(lambda: dense_plain(x, w, b, act), 5),
                library_ms=cuda_ms(lambda: x @ w + b, 5),
                bound=split_tf32_bound(4.0 * (m * k + k * n + n + m * n),
                                       2.0 * m * k * n))
        del got, want, x, w, b
        torch.cuda.empty_cache()
        print_row(f"dense [{label}, M={m} K={k} N={n} act={act}]", row)
        rows[label] = row
    first, *rest = DENSE_SHAPES
    return {DENSE_KERNEL: rows[first] | {"shapes": {
        label: {key: rows[label][key] for key in (
            "max_abs_err", "ms", "graph_ms", "plain_ms", "library_ms")}
        | {"bound_ms": rows[label]["bound"][0],
           "bound_by": rows[label]["bound"][1]}
        for label in DENSE_SHAPES}}}


def small_parity_phase() -> None:
    """The whole port on a small input, card vs CPU: same decisions."""
    spec = FleetRunSpec(provider="detector", n_cameras=3, n_steps=3,
                        shortlist_k=SHORTLIST_K)
    on_card = run_fleet(spec)
    on_cpu = run_fleet(spec, device="cpu")
    if (on_card.chosen != on_cpu.chosen
            or on_card.frames_sent != on_cpu.frames_sent):
        raise AssertionError(
            f"card vs CPU decisions differ: {on_card.chosen} "
            f"{on_card.frames_sent} vs {on_cpu.chosen} "
            f"{on_cpu.frames_sent}")
    err = max(abs(a - b) for a, b in zip(on_card.acc_per_step,
                                         on_cpu.acc_per_step))
    if err > 1e-6:
        raise AssertionError(f"card vs CPU accuracy differs by {err}")
    print(f"small input: card and CPU agree (chosen {on_card.chosen}, "
          f"frames_sent {on_card.frames_sent})", flush=True)


class SearchRecorder:
    """While active, records the arguments and results of every
    shape_search and budget_walk call that fleet_step makes (clones, by
    wrapping the names fleet/step.py calls). The wrapped call is the
    wrapper itself, launched once as always."""

    NAMES = ("shape_search_batch", "budget_walk_batch")

    def __init__(self):
        self.calls = {name: [] for name in self.NAMES}

    def _wrap(self, name, fn):
        def recorded(cfg, statics, *args):
            out = fn(cfg, statics, *args)
            self.calls[name].append((cfg, statics, _clone(args),
                                     _clone(out)))
            return out
        return recorded

    def __enter__(self):
        self.saved = {n: getattr(step_module, n) for n in self.NAMES}
        for name, fn in self.saved.items():
            setattr(step_module, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(step_module, name, fn)


class CallRecorder:
    """While active, keeps keep(args, kwargs, out) of every call of
    `module.name` (by wrapping the name its callers look up); the wrapped
    function runs once per call as always."""

    def __init__(self, module, name, keep):
        self.module, self.name, self.keep = module, name, keep
        self.calls = []

    def __enter__(self):
        self.saved = getattr(self.module, self.name)

        def recorded(*args, **kwargs):
            out = self.saved(*args, **kwargs)
            self.calls.append(self.keep(args, kwargs, out))
            return out

        setattr(self.module, self.name, recorded)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def _keep_call(args, kwargs, out):
    return _clone(args), _clone(kwargs), _clone(out)


def OracleRecorder():
    """While active, records the arguments and results of every
    oracle_pass call that observe_all_cells makes (clones, by wrapping
    the name scene/observe.py calls)."""
    return CallRecorder(observe_module, "oracle_pass", _keep_call)


def PatchifyRecorder():
    """While active, records the arguments and result of every
    crop_patchify kernel call (clones, by wrapping crop_patchify_batch,
    the name kernels/crop_patchify/ops.crop_patchify calls)."""
    return CallRecorder(patchify_module, "crop_patchify_batch", _keep_call)


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, tuple):            # NamedTuples keep their type
        vals = [_clone(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    return x


_draws = {"n": 0, "wrapped": False}


def reset_counts() -> None:
    """The kernels' launch counters and the count of draws on the card
    set to 0. The first call wraps scene/prng.py's public draws (every
    caller reaches them as prng.<name>) to count the calls on a CUDA key
    with values, each of which must launch threefry once."""
    if not _draws["wrapped"]:
        for name in DRAWS:
            def draw(key, *args, _fn=getattr(prng, name), **kwargs):
                if prng._on_card(key):
                    _draws["n"] += 1
                return _fn(key, *args, **kwargs)
            setattr(prng, name, draw)
        _draws["wrapped"] = True
    _lib.reset_launch_counts()
    _draws["n"] = 0


def launch_counts(keep_draws: bool = False,
                  keep_dense: bool = False) -> dict:
    """The launches since reset_counts(). threefry's must equal the
    draws on the card (one launch each: none ran the plain version);
    then it is left out, unless `keep_draws`, so each path's "these
    kernels and no other" checks read the kernels of the path. dense is
    left out too, unless `keep_dense`: the paths that know their
    linears (the main path, stablelm-3b in float32) ask for it and check
    one launch per linear."""
    counts = _lib.launch_counts()
    if counts[DRAW_KERNEL] != _draws["n"]:
        raise AssertionError(f"{counts[DRAW_KERNEL]} threefry launches for "
                             f"{_draws['n']} draws on the card")
    if not keep_draws:
        del counts[DRAW_KERNEL]
    if not keep_dense:
        del counts[DENSE_KERNEL]
    return counts


def _launched_only(counts, kernels, n, label) -> None:
    """Raise unless exactly `kernels` launched, each `n` times."""
    uneven = [k for k in kernels if counts[k] != n]
    stray = [k for k, v in counts.items() if v and k not in kernels]
    if uneven or stray:
        raise AssertionError(f"{label}: launches {counts}, want "
                             f"{kernels} x {n} only")


class StepDraws:
    """While active, keeps the threefry launches of every episode_step
    call (the warm-up's by the name fleet/api.py calls, the episode's by
    fleet/runner.py's)."""

    MODULES = (api_module, runner_module)

    def __enter__(self):
        self.per_step = []
        self.saved = [m.episode_step for m in self.MODULES]

        def counted_step(*args, _fn=self.saved[0], **kwargs):
            before = _lib.LAUNCHES[DRAW_KERNEL]
            out = _fn(*args, **kwargs)
            self.per_step.append(_lib.LAUNCHES[DRAW_KERNEL] - before)
            return out

        for m in self.MODULES:
            m.episode_step = counted_step
        return self

    def __exit__(self, *exc):
        for m, fn in zip(self.MODULES, self.saved):
            m.episode_step = fn


def main_path_phase(spec: FleetRunSpec):
    """Drive run_fleet once at the main path's cell; return (result,
    launch counts of that run, the recorded shape-search calls, the
    recorded oracle-pass calls)."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with SearchRecorder() as rec, OracleRecorder() as orec, \
            StepDraws() as draws:
        result = run_fleet(spec)
    counts = launch_counts(keep_draws=True, keep_dense=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    chosen = torch.tensor(result.chosen)
    acc = torch.tensor(result.acc_per_step)
    if chosen.shape != (N_STEPS, N_CAMERAS):
        raise AssertionError(f"chosen has shape {tuple(chosen.shape)}")
    if not bool(((chosen >= 0) & (chosen < DEFAULT_GRID.n_cells)).all()):
        raise AssertionError("chosen cell out of range")
    if not (bool(torch.isfinite(acc).all()) and bool((acc >= 0).all())
            and bool((acc <= 1).all())):
        raise AssertionError(f"accuracy not in [0, 1]: {acc}")
    if len(result.frames_sent) != N_STEPS or min(result.frames_sent) < 0:
        raise AssertionError(f"frames_sent malformed: "
                             f"{result.frames_sent}")
    missing = [k for k in MAIN_PATH_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    uneven = [k for k in MAIN_PATH_KERNELS if counts[k] != N_STEPS + 1]
    if uneven:
        raise AssertionError(f"main-path kernels not launched once per "
                             f"step: {uneven} ({counts})")
    stray = [k for k, v in counts.items()
             if v and k not in MAIN_PATH_KERNELS + (DRAW_KERNEL,
                                                    DENSE_KERNEL)]
    if stray:
        raise AssertionError(f"kernels off the main path launched on it: "
                             f"{stray}")
    # the ViT's linears, one dense launch each, one forward a step
    if counts[DENSE_KERNEL] != VIT_LINEARS * (N_STEPS + 1):
        raise AssertionError(f"dense launched {counts[DENSE_KERNEL]} times "
                             f"on the main path, want {VIT_LINEARS} a "
                             f"step")
    # every draw of the scene advance and the render noise one threefry
    # launch (launch_counts: none ran the plain version)
    if draws.per_step != [STEP_DRAWS] * (N_STEPS + 1):
        raise AssertionError(f"threefry launches a step {draws.per_step}, "
                             f"want {STEP_DRAWS} in each")
    t = result.timings
    print(f"main path: accuracy={result.accuracy:.6f} "
          f"frames_sent={list(result.frames_sent)} "
          f"compile_s={t['compile_s']:.3f} steady_s={t['steady_s']:.3f} "
          f"camera_steps_per_s={result.camera_steps_per_s:.2f} "
          f"peak_mem_gib={peak:.2f} launches={counts} "
          f"(over {N_STEPS} steps + 1 warm-up step; threefry "
          f"{STEP_DRAWS} a step, {counts[DRAW_KERNEL] - sum(draws.per_step)}"
          f" in set-up)", flush=True)
    return result, counts, rec.calls, orec.calls


def oracle_phase(calls, steps: int = N_STEPS + 1, tag: str = "") -> dict:
    """oracle_pass against its plain version on the inputs of every step
    of the main-path episode: counts, nbox and acc_true exactly equal;
    areas, centroid and extent within 1e-5 (absolute + relative: float32
    sums over objects in another order), the spread within 1e-2 as a
    variance (it cancels: the tolerance of the CPU tests against the JAX
    package). Timed on the last step's inputs (ms: Python calls;
    graph_ms: a CUDA graph of the calls). Returns its row."""
    if len(calls) != steps:
        raise AssertionError(f"oracle_pass: {len(calls)} calls recorded, "
                             f"want {steps}")
    errs = {k: 0.0 for k in ("areas", "centroid", "extent", "spread")}
    for step, (args, kw, got) in enumerate(calls):
        want = oracle_pass_plain(*args, **kw)
        for name in ("counts", "nbox", "acc_true"):
            g, w = getattr(got, name), getattr(want, name)
            if not torch.equal(g, w):
                raise AssertionError(
                    f"oracle_pass step {step}: {name} differs from the "
                    f"plain version in {int((g != w).sum())} places")
        for name in ("areas", "centroid", "extent"):
            check_close(f"oracle_pass step {step} {name}",
                        (getattr(got, name),), (getattr(want, name),),
                        atol=1e-5, rtol=1e-5)
        check_close(f"oracle_pass step {step} spread^2",
                    (got.spread ** 2,), (want.spread ** 2,), atol=1e-2,
                    rtol=1e-5)
        for name in errs:
            errs[name] = max(errs[name], max_err((getattr(got, name),),
                                                 (getattr(want, name),)))
    args, kw, got = calls[-1]
    _, teach, _, state, _, windows = args
    f, m = state.oid.shape
    p = teach.a0.shape[0]
    c = windows.shape[0]
    q = len(kw["pair_idx"])
    # inputs: pos, size, oid, enabled, t, cam_salt, 4 f32 + 2 i64 teacher
    # rows, windows, the queries (kernel parameters); outputs:
    # counts/areas, centroid, spread, extent, acc_true (f32), nbox (i64)
    n_bytes = (f * m * (8 + 8 + 8 + 1) + 16 * f + p * (16 + 16) + 16 * c
               + 8 * q + f * c * (8 * p + 8 + 12 + 8))
    # per (camera, object, window): ~25 geometry ops + ~6 per channel of
    # 2P; per (camera, pair, object): three hashes of ~24 ops
    n_ops = f * m * c * (25 + 12 * p) + f * p * m * 72

    def run():
        return oracle_pass(*args, **kw)

    row = dict(max_abs_err=max(errs.values()),
               ms=cuda_ms(run, 200), graph_ms=graph_ms(run, 200),
               plain_ms=cuda_ms(lambda: oracle_pass_plain(*args, **kw), 20),
               bound=bound(n_bytes, n_ops), library_ms=None)
    exact = all(torch.equal(getattr(got, k), getattr(want, k))
                for k in errs)
    print(f"oracle_pass{tag}: kernel and plain agree on all {len(calls)} "
          f"steps "
          f"of the episode (counts, nbox, acc_true exact; max abs err "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f"; last step's floats exactly equal: {exact})", flush=True)
    print_row("oracle_pass" + tag, row)
    return row


def search_phase(calls, steps: int = N_STEPS + 1, tag: str = "") -> dict:
    """shape_search and budget_walk against their plain versions on the
    inputs of every step of the main-path episode: masks, walk orders and
    counts exactly equal, the walk time within 1e-6 relative (its hop sum
    in another order). Both timed on the last step's inputs (ms: Python
    calls; graph_ms: a CUDA graph of the calls). Returns their rows."""
    rows = {}
    plains = {"shape_search_batch": shape_search_plain,
              "budget_walk_batch": budget_walk_plain}
    wrappers = {"shape_search_batch": shape_search_batch,
                "budget_walk_batch": budget_walk_batch}
    for name, recorded in calls.items():
        kernel = name[:-len("_batch")]
        if len(recorded) != steps:
            raise AssertionError(f"{kernel}: {len(recorded)} calls recorded, "
                                 f"want {steps}")
        err = 0.0
        for step, (cfg, statics, args, got) in enumerate(recorded):
            want = plains[name](cfg, statics, *args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for i, (g, w) in enumerate(zip(got, want)):
                if g.dtype == torch.float32:
                    check_close(f"{kernel} step {step} t", (g,), (w,),
                                atol=0.0, rtol=1e-6)
                    err = max(err, float((g - w).abs().max()))
                elif not torch.equal(g, w):
                    bad = (g != w).reshape(g.shape[0], -1).any(1)
                    cams = torch.nonzero(bad).flatten().tolist()
                    raise AssertionError(
                        f"{kernel} step {step} output {i}: cameras {cams} "
                        f"decide otherwise than the plain version")
        cfg, statics, args, _ = recorded[-1]
        f, n = args[0].shape
        if kernel == "shape_search":
            n_bytes = (f * n * (1 + 4 + 8 + 1 + 1) + 8 * f + 9 * n * n
                       + 8 * n)
        else:
            n_bytes = f * n * (1 + 4 + 1 + 8) + 24 * f + 14 * n * n

        def run(fn=wrappers[name]):
            return fn(cfg, statics, *args)

        rows[kernel] = dict(
            max_abs_err=err, ms=cuda_ms(run, 200), graph_ms=graph_ms(run, 200),
            plain_ms=cuda_ms(lambda: plains[name](cfg, statics, *args), 3),
            # a search that may stop at its first test needs no fixed
            # count of operations: the bound is the bytes
            bound=bound(n_bytes, 0.0), library_ms=None)
        print(f"{kernel}{tag}: kernel and plain decide alike on all "
              f"{len(recorded)} steps of the episode", flush=True)
        print_row(kernel + tag, rows[kernel])
    return rows


def random_search_args(dev, grid, f: int, seed: int):
    """Seeded search states with ties: scattered shapes of up to half the
    grid (the head/tail loop, structural tails, shrinking), labels in
    quarters (many zeros), budgets that fit nothing, everything or in
    between. -> (cfg, statics, shape_search args, budget_walk args)."""
    gen = torch.Generator().manual_seed(seed)
    n = grid.n_cells

    def rand(*shape):
        return torch.rand(shape, generator=gen)

    shape = rand(f, n) < 0.5 * rand(f, 1)
    labels = torch.floor(4 * rand(f, n)) / 4
    has = rand(f, n) < 0.6
    cent = (torch.as_tensor(grid.centers, dtype=torch.float32)[None]
            + 12.0 * (rand(f, n, 2) - 0.5))
    max_cells = torch.randint(0, n + 3, (f,), generator=gen)
    start = torch.randint(0, n, (f,), generator=gen)
    budget = 0.6 * rand(f)
    budget[::5] = 0.0
    budget[1::5] = 1e3
    ss = [x.to(dev) for x in (shape, labels, cent, has, max_cells)]
    bw = [ss[0], start.to(dev), ss[1], budget.to(dev), 0.0]
    return fleet_config(grid), fleet_statics(grid, dev), ss, bw


def random_search_phase(dev) -> None:
    """shape_search and budget_walk against their plain versions on
    seeded states at the main path's shapes (64 cameras, 25 cells):
    decisions exactly equal, the walk time within 1e-6 relative. Then
    their device times (CUDA graph) at larger fleets and grids."""
    for seed in range(3):
        cfg, st, ss, bw = random_search_args(dev, DEFAULT_GRID, N_CAMERAS,
                                             seed)
        pairs = ((shape_search_batch(cfg, st, *ss),
                  shape_search_plain(cfg, st, *ss)),
                 *zip(budget_walk_batch(cfg, st, *bw),
                      budget_walk_plain(cfg, st, *bw)))
        for i, (got, want) in enumerate(pairs):
            if got.dtype == torch.float32:
                check_close(f"random state {seed} t", (got,), (want,),
                            atol=0.0, rtol=1e-6)
            elif not torch.equal(got, want):
                raise AssertionError(f"random state {seed} output {i}: "
                                     f"kernel and plain decide otherwise")
    print("shape_search, budget_walk: kernel and plain decide alike on 3 "
          f"random states of {N_CAMERAS} cameras x 25 cells", flush=True)
    big = OrientationGrid(pan_step=9.375, tilt_step=9.375)     # 16 x 8
    times = []
    for grid in (DEFAULT_GRID, big):
        for f in (N_CAMERAS, 1024):
            cfg, st, ss, bw = random_search_args(dev, grid, f, 7)
            ss_ms = graph_ms(lambda: shape_search_batch(cfg, st, *ss), 20)
            bw_ms = graph_ms(lambda: budget_walk_batch(cfg, st, *bw), 20)
            times.append(f"F={f} N={grid.n_cells}: shape_search "
                         f"{ss_ms:.4f} budget_walk {bw_ms:.4f}")
    print("search kernels on random states, graph_ms per call: "
          + "; ".join(times), flush=True)


def patchify_phase(calls, steps: int, tag: str) -> dict:
    """crop_patchify against its plain version on the inputs of every
    recorded call of an episode (tokens within 1e-4, as in kernel_phase),
    timed on the last call's inputs. Returns its row."""
    if len(calls) != steps:
        raise AssertionError(f"crop_patchify: {len(calls)} calls "
                             f"recorded, want {steps}")
    err = 0.0
    for step, (args, kw, got) in enumerate(calls):
        want = crop_patchify_plain(*args, **kw)
        check_close(f"crop_patchify{tag} step {step}", (got,), (want,),
                    atol=1e-4)
        err = max(err, max_err((got,), (want,)))
    args, kw, _ = calls[-1]
    print(f"crop_patchify{tag}: kernel and plain agree on all {steps} "
          f"steps (max abs err {err:.3e})", flush=True)
    row = dict(
        max_abs_err=err, ms=cuda_ms(lambda: crop_patchify_batch(*args, **kw),
                                    10),
        plain_ms=cuda_ms(lambda: crop_patchify_plain(*args, **kw), 3),
        bound=patchify_bound(args, kw), library_ms=None)
    print_row("crop_patchify" + tag, row)
    return row


def beyond_limits_phase(dev) -> None:
    """The main path past the kernels' old limits: run_fleet(provider=
    "detector") at full width on the 200-cell grid with a 40-slot scene,
    BIG_CAMERAS cameras, BIG_STEPS steps (+1 warm-up), counters set to 0
    just before and read just after: crop_patchify, oracle_pass,
    shape_search and budget_walk launch once per step, and every
    recorded call equals its plain version on the same inputs on the
    card, each timed on its last call. Then the same spec at 2 cameras
    with the smoke detector on the card and on the CPU must decide
    alike, and oracle_pass runs a 256-slot scene."""
    steps = BIG_STEPS + 1
    spec = FleetRunSpec(
        provider="detector", n_cameras=BIG_CAMERAS, n_steps=BIG_STEPS,
        shortlist_k=SHORTLIST_K, grid=BIG_GRID,
        provider_kwargs={"det_cfg": get_config("madeye-approx"),
                         "spec": SceneSpec(**BIG_SCENE)})
    n_cells = OrientationGrid(**BIG_GRID).n_cells
    torch.cuda.synchronize()
    reset_counts()
    with (SearchRecorder() as rec, OracleRecorder() as orec,
          PatchifyRecorder() as prec):
        result = run_fleet(spec)
    torch.cuda.synchronize()
    counts = launch_counts()
    _launched_only(counts, MAIN_PATH_KERNELS, steps,
                   "beyond the old limits")
    chosen = torch.tensor(result.chosen)
    acc = torch.tensor(result.acc_per_step)
    if (chosen.shape != (BIG_STEPS, BIG_CAMERAS)
            or not bool(((chosen >= 0) & (chosen < n_cells)).all())
            or not bool(((acc >= 0) & (acc <= 1)).all())):
        raise AssertionError(f"beyond the old limits: malformed result "
                             f"{result.chosen} {result.acc_per_step}")
    print(f"beyond the old limits: {n_cells} cells, "
          f"{sum(BIG_SCENE.values())} slots, {BIG_CAMERAS} cameras x "
          f"{BIG_STEPS} steps: accuracy={result.accuracy:.6f} "
          f"frames_sent={list(result.frames_sent)} launches={counts}",
          flush=True)
    tag = f"[{n_cells} cells, M={sum(BIG_SCENE.values())}]"
    oracle_phase(orec.calls, steps, tag)
    search_phase(rec.calls, steps, tag)
    patchify_phase(prec.calls, steps, tag)

    # the same spec, 2 cameras, the smoke detector: card vs CPU
    small = dataclasses.replace(spec, n_cameras=2, provider_kwargs={
        "spec": SceneSpec(**BIG_SCENE)})
    on_card, on_cpu = run_fleet(small), run_fleet(small, device="cpu")
    same = (on_card.chosen == on_cpu.chosen
            and on_card.frames_sent == on_cpu.frames_sent
            and all(torch.equal(getattr(on_card.out, k).cpu(),
                                getattr(on_cpu.out, k))
                    for k in ("explored", "order", "zooms", "sent")))
    if not same:
        raise AssertionError(f"beyond the old limits: card vs CPU "
                             f"decisions differ: {on_card.chosen} vs "
                             f"{on_cpu.chosen}")
    print(f"beyond the old limits, small input: card and CPU agree "
          f"(chosen {on_card.chosen})", flush=True)

    # oracle_pass on a 256-slot scene (8 chunks of 32 objects)
    sspec = SceneSpec(max_people=128, max_cars=128)
    params, rng = scene_fleet_params(sspec, N_CAMERAS, device=dev)
    sc = advance_scene(sspec, params, rng, init_scene(sspec, params, rng),
                       2, 4)
    wl = workload_spec(FleetRunSpec().workload_obj())
    teach = teacher_arrays(wl.pairs, device=dev)
    oargs = (sspec, teach, params, sc,
             torch.full((N_CAMERAS,), 6, dtype=torch.int64, device=dev),
             grid_windows(DEFAULT_GRID, device=dev))
    okw = dict(task_id=wl.task_id, pair_idx=wl.pair_idx, n_zoom=3,
               cam_salt=rng[:, 0])
    reset_counts()
    got = oracle_pass(*oargs, **okw)
    if launch_counts()["oracle_pass"] != 1:
        raise AssertionError("oracle_pass at 256 slots did not launch")
    oracle_phase([(oargs, okw, got)], 1, "[25 cells, M=256]")


def FleetRecorder():
    """While active, keeps the FleetResult of every run_fleet call the
    serving launcher makes (by wrapping the name launch/serve.py
    calls)."""
    return CallRecorder(serve_module, "run_fleet", lambda a, kw, out: out)


ACC_LINE = re.compile(r"^(.+?)\s*:\s*acc=([0-9.]+)", re.M)


def _serve(**kwargs):
    """serve(**kwargs) with its printout captured -> (the printout, the
    {line label: accuracy} it printed, the FleetResults it made)."""
    buf = io.StringIO()
    with FleetRecorder() as frec, contextlib.redirect_stdout(buf):
        serve_module.serve(**kwargs)
    out = buf.getvalue()
    accs = {k.strip(): v for k, v in ACC_LINE.findall(out)}
    return out, accs, frec.calls


def _check_tables_result(result, n_cells, label) -> None:
    chosen = torch.tensor(result.chosen)
    acc = torch.tensor(result.acc_per_step)
    if (chosen.shape != (SERVE_STEPS, N_CAMERAS)
            or not bool(((chosen >= 0) & (chosen < n_cells)).all())
            or not bool(torch.isfinite(acc).all())
            or not bool(((acc >= 0) & (acc <= 1)).all())):
        raise AssertionError(f"{label}: malformed result {result.chosen} "
                             f"{result.acc_per_step}")
    # one shared world: every camera decides alike
    for k in ("explored", "order", "zooms", "sent", "chosen"):
        x = getattr(result.out, k)
        if not torch.equal(x, x[:, :1].expand_as(x)):
            raise AssertionError(f"{label}: cameras of the shared world "
                                 f"disagree on {k}")


def fleet_spans(tracer) -> list:
    """(name, ms) of the tracer's `fleet/*` spans (run_fleet's build,
    warm-up and steady phases), leaving out the per-step `madeye/*`
    spans."""
    return [(e["name"], e["dur"] / 1e3) for e in tracer.events
            if e["name"].startswith("fleet/")]


def serve_phase(dev) -> dict:
    """The serving launcher on the card (phase 8b); returns the search
    kernels' rows of its two tables episodes and every path's launches."""
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    events_path = out_dir / "serve_events.jsonl"
    trace_path = out_dir / "serve_trace.json"
    events_path.unlink(missing_ok=True)
    steps = SERVE_STEPS + 1
    paths, rows = {}, {}

    # serve --fleet 64 at its defaults, telemetry to a file, in a trace
    torch.cuda.synchronize()
    reset_counts()
    with (tracing(str(trace_path)) as tracer,
          SearchRecorder() as rec):
        out, _, (result,) = _serve(**SERVE, fleet=N_CAMERAS,
                                   provider="tables",
                                   telemetry=str(events_path))
    torch.cuda.synchronize()
    counts = launch_counts()
    print(out.rstrip(), flush=True)
    label = f"serve --fleet {N_CAMERAS} [tables, 25 cells]"
    _launched_only(counts, SEARCH_KERNELS, steps, label)
    paths[label] = counts
    _check_tables_result(result, DEFAULT_GRID.n_cells, label)
    events = read_events(str(events_path))
    kinds = [e["event"] for e in events]
    n_chunks = math.ceil(SERVE_STEPS / 16)
    if kinds != ["run_start"] + ["steps"] * n_chunks + ["run_end"]:
        raise AssertionError(f"{label}: events {kinds}")
    spans = fleet_spans(tracer)
    missing = {"fleet/build", "fleet/compile", "fleet/steady"} - {
        n for n, _ in spans}
    if missing:
        raise AssertionError(f"{label}: spans missing from the trace: "
                             f"{sorted(missing)}")
    t = result.timings
    print(f"{label}: accuracy={result.accuracy:.6f} "
          f"build_s={t['build_s']:.3f} compile_s={t['compile_s']:.3f} "
          f"steady_s={t['steady_s']:.3f} "
          f"camera_steps_per_s={result.camera_steps_per_s:.2f} "
          f"events={len(events)} (all valid) spans_ms="
          + json.dumps({n: round(d, 3) for n, d in spans})
          + f" launches={counts} (over {SERVE_STEPS} steps + 1 warm-up "
          f"step)", flush=True)
    rows[label] = search_phase(rec.calls, steps, f"[{label}]")

    # the same fleet on the 200-cell grid, through the spec API
    grid = OrientationGrid(**BIG_GRID)
    wl = serve_module.DEFAULT_WORKLOAD
    t0 = time.perf_counter()
    video = build_video(grid, SceneConfig(fps=15, seed=3), SERVE["duration"])
    tables = detection_tables(video, wl)
    acc = workload_acc_table(video, wl, tables)
    host_s = time.perf_counter() - t0
    spec = FleetRunSpec.from_objects(
        "tables", n_cameras=N_CAMERAS, grid=grid, workload=wl,
        budget=BudgetConfig(fps=SERVE["fps"]), video=video, tables=tables,
        trace=NetworkTrace.fixed(24.0, 20.0, video.n_frames),
        acc_table=acc)
    torch.cuda.synchronize()
    reset_counts()
    with tracing() as tracer, SearchRecorder() as rec:
        result = run_fleet(spec)
    torch.cuda.synchronize()
    counts = launch_counts()
    label = f"run_fleet tables x{N_CAMERAS} [{grid.n_cells} cells]"
    _launched_only(counts, SEARCH_KERNELS, steps, label)
    paths[label] = counts
    _check_tables_result(result, grid.n_cells, label)
    t = result.timings
    print(f"{label}: substrate (video, teacher tables, accuracy) built on "
          f"the host in {host_s:.1f} s ({video.n_frames} frames x "
          f"{grid.n_cells} cells); accuracy={result.accuracy:.6f} "
          f"build_s={t['build_s']:.3f} (episode tables) "
          f"compile_s={t['compile_s']:.3f} steady_s={t['steady_s']:.3f} "
          f"camera_steps_per_s={result.camera_steps_per_s:.2f} spans_ms="
          + json.dumps({n: round(d, 3) for n, d in fleet_spans(tracer)})
          + f" launches={counts}", flush=True)
    rows[label] = search_phase(rec.calls, steps, f"[{label}]")

    # serve --fleet 4 on the card and on the CPU
    small = dict(fps=2.0, duration=3.0, fleet=4)
    _, card_accs, (on_card,) = _serve(**small)
    _, cpu_accs, (on_cpu,) = _serve(**small, device="cpu")
    same = card_accs == cpu_accs and len(card_accs) == 8 and all(
        torch.equal(getattr(on_card.out, k).cpu(), getattr(on_cpu.out, k))
        for k in ("chosen", "explored", "order", "zooms", "sent"))
    if not same:
        raise AssertionError(f"serve --fleet 4: card and CPU differ: "
                             f"{card_accs} vs {cpu_accs}")
    print(f"serve --fleet 4, small input: card and CPU print the same "
          f"accuracies {card_accs} and decide alike (chosen "
          f"{on_card.chosen})", flush=True)

    # the detector branch: shortlist, distillation, telemetry
    det_events = out_dir / "serve_detector_events.jsonl"
    det_events.unlink(missing_ok=True)
    det_steps = int(SERVE_DETECTOR["duration"] * SERVE_DETECTOR["fps"])
    torch.cuda.synchronize()
    reset_counts()
    with (SearchRecorder() as rec, OracleRecorder() as orec,
          PatchifyRecorder() as prec):
        out, _, (result,) = _serve(**SERVE_DETECTOR,
                                   telemetry=str(det_events))
    torch.cuda.synchronize()
    counts = launch_counts()
    print(out.rstrip(), flush=True)
    label = (f"serve --fleet {SERVE_DETECTOR['fleet']} [detector, "
             f"shortlist {SHORTLIST_K}, distill]")
    _launched_only(counts, MAIN_PATH_KERNELS, det_steps + 1, label)
    paths[label] = counts
    steps_ev = [e for e in read_events(str(det_events))
                if e["event"] == "steps"]
    if not steps_ev or any(
            len(e["cameras"].get("distill_loss", ())) != result.n_cameras
            for e in steps_ev):
        raise AssertionError(f"{label}: events without distill_loss")
    if result.distill_loss is None or "  distill: " not in out:
        raise AssertionError(f"{label}: no distillation ran")
    print(f"{label}: accuracy={result.accuracy:.6f} distill_loss="
          f"{[round(v, 6) for v in result.distill_loss]} "
          f"launches={counts} (over {det_steps} steps + 1 warm-up step)",
          flush=True)
    oracle_phase(orec.calls, det_steps + 1, f"[{label}]")
    search_phase(rec.calls, det_steps + 1, f"[{label}]")
    patchify_phase(prec.calls, det_steps + 1, f"[{label}]")
    return {"rows": rows, "paths": paths}


def _tree_equal(a, b) -> bool:
    return all(torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _per_camera_equal(per_camera, shared) -> bool:
    """Every camera's row of `per_camera` bit-equal to `shared`."""
    return all(torch.equal(x, y[None].expand_as(x)) for x, y in zip(
        tree_leaves(per_camera), tree_leaves(shared)))


def distill_phase(spec: FleetRunSpec, frozen_steady_s: float, dev,
                  label: str) -> dict:
    """The learning path: run_fleet with spec.distill and spec.metrics
    at the main path's cell, counters set to 0 just before and read just
    after: oracle_pass, crop_patchify, shape_search and budget_walk once
    per step (the update launches no kernel of its own) and no other;
    every recorded call equal to its plain version; the per-step loss
    finite and >= 0 on updating steps; the learned heads (or networks)
    moved; the backbone (full mode: the patch embedding) bit-unchanged
    against the initial weights, made again from the same seed. Prints
    the run's line; returns its launch counts and timings."""
    steps = spec.n_steps + 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with (SearchRecorder() as rec, OracleRecorder() as orec,
          PatchifyRecorder() as prec):
        result = run_fleet(spec)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    _launched_only(counts, MAIN_PATH_KERNELS, steps, label)
    chosen = torch.tensor(result.chosen)
    acc = torch.tensor(result.acc_per_step)
    if (chosen.shape != (spec.n_steps, spec.n_cameras)
            or not bool(((chosen >= 0) & (chosen < DEFAULT_GRID.n_cells))
                        .all())
            or not bool(((acc >= 0) & (acc <= 1)).all())):
        raise AssertionError(f"{label}: malformed result {result.chosen} "
                             f"{result.acc_per_step}")
    loss = torch.tensor(result.distill_loss)
    every = spec.distill.every
    upd = torch.tensor([(e + 1) % every == 0 for e in range(spec.n_steps)])
    if not (bool(torch.isfinite(loss).all()) and bool((loss[upd] >= 0).all())
            and bool((loss[~upd] == -1.0).all())):
        raise AssertionError(f"{label}: distill_loss {result.distill_loss}")
    step_loss = result.metrics["distill_loss"]
    if not bool(torch.isfinite(step_loss).all()):
        raise AssertionError(f"{label}: per-camera loss not finite")

    provider, _ = result.learned
    init = detector_init(torch.Generator().manual_seed(0), provider.det_cfg,
                         dev)
    if not _tree_equal(provider.det_params, init):
        raise AssertionError(f"{label}: the shared detector params were "
                             f"written")
    learned = result.learned_params(None)
    if spec.distill.head_only:
        frozen_ok = _tree_equal(learned["backbone"], init["backbone"])
    else:
        frozen_ok = _per_camera_equal(
            learned["backbone"]["vit"]["patch_embed"],
            init["backbone"]["vit"]["patch_embed"])
    moved = not _per_camera_equal(learned["heads"], init["heads"])
    if not frozen_ok:
        raise AssertionError(f"{label}: frozen params changed")
    if not moved:
        raise AssertionError(f"{label}: the learned heads did not move")

    tag = f"[{label}]"
    rows = {"oracle_pass": oracle_phase(orec.calls, steps, tag),
            **search_phase(rec.calls, steps, tag),
            "crop_patchify": patchify_phase(prec.calls, steps, tag)}
    t = result.timings
    ranks = result.metrics["chosen_rank"]
    rank = median_valid_rank(ranks)
    gradable = f"{int((ranks > 0).sum())} of {ranks.numel()}"
    print(f"{label}: accuracy={result.accuracy:.6f} "
          f"frames_sent={list(result.frames_sent)} "
          f"compile_s={t['compile_s']:.3f} steady_s={t['steady_s']:.3f} "
          f"camera_steps_per_s={result.camera_steps_per_s:.2f} "
          f"peak_mem_gib={peak:.2f} (with the recorders' clones of every "
          f"kernel call) "
          f"steady_s/frozen={t['steady_s'] / frozen_steady_s:.3f} "
          f"distill_loss={[round(v, 6) for v in result.distill_loss]} "
          f"chosen_rank_median={rank} (camera-steps gradable: {gradable}; "
          f"a step with fewer than 2 explored cells is not) "
          f"launches={counts} (over "
          f"{spec.n_steps} steps + 1 warm-up step; backbone"
          f"{'' if spec.distill.head_only else ' patch embedding'} "
          f"bit-unchanged, heads moved)", flush=True)
    return dict(counts=counts, timings=t, rows=rows)


def distill_parity_phase() -> None:
    """Small input with learning on: the smoke detector, 2 cameras, 8
    steps, shortlist_k=9, a 3 fps budget (several cells explored per
    step, so chosen_rank is gradable), DistillSpec(), on the card and on
    the CPU:
    the decisions (explored, order, zooms, sent, chosen) equal; the
    per-step loss within 1e-4 relative (float32 convolutions and sums
    in other orders); the learned heads: 98% of elements within 1e-5 and
    every one within 3 lr per update (an AdamW element whose gradient is
    at round-off level steps by up to ~lr either way on either side)."""
    spec = FleetRunSpec(provider="detector", n_cameras=2, n_steps=N_STEPS,
                        shortlist_k=9, budget={"fps": 3.0}, seed=3,
                        distill=DistillSpec(), metrics=MetricsSpec())
    on_card, on_cpu = run_fleet(spec), run_fleet(spec, device="cpu")
    frozen = run_fleet(dataclasses.replace(spec, distill=None))
    for k in ("explored", "order", "zooms", "sent", "chosen"):
        if not torch.equal(getattr(on_card.out, k).cpu(),
                           getattr(on_cpu.out, k)):
            raise AssertionError(f"learning, small input: card vs CPU "
                                 f"{k} differ: {on_card.chosen} vs "
                                 f"{on_cpu.chosen}")
    loss_c = torch.tensor(on_card.distill_loss)
    loss_h = torch.tensor(on_cpu.distill_loss)
    loss_err = float(((loss_c - loss_h).abs() / loss_h.abs()).max())
    if loss_err > 1e-4:
        raise AssertionError(f"learning, small input: loss differs by "
                             f"{loss_err} relative")
    errs = torch.cat([(x.cpu() - y).abs().reshape(-1) for x, y in zip(
        tree_leaves(on_card.learned_params(None)["heads"]),
        tree_leaves(on_cpu.learned_params(None)["heads"]))])
    close = float((errs <= 1e-5).float().mean())
    if close < 0.98 or float(errs.max()) > 3 * DistillSpec().lr * N_STEPS:
        raise AssertionError(f"learning, small input: heads differ "
                             f"({close:.4f} within 1e-5, max "
                             f"{float(errs.max()):.3e})")
    print(f"learning, small input: card and CPU agree (chosen "
          f"{on_card.chosen}; loss max rel err {loss_err:.3e}; heads "
          f"{close:.4f} of elements within 1e-5, max abs err "
          f"{float(errs.max()):.3e}); chosen_rank median on the card "
          f"{median_valid_rank(on_card.metrics['chosen_rank'])} learning, "
          f"{median_valid_rank(frozen.metrics['chosen_rank'])} frozen",
          flush=True)


def raw_scores(cls_logits, obj_logits):
    """Raw head outputs -> (every cell's score [B, g*g], the margin
    between its two most probable classes [B, g*g]), as the decode
    computes them before its top-k."""
    b = cls_logits.shape[0]
    probs = torch.softmax(
        cls_logits.reshape(b, -1, cls_logits.shape[-1]).float(), dim=-1)
    score = torch.sigmoid(obj_logits.reshape(b, -1).float()) * probs.amax(-1)
    top2 = probs.topk(2, dim=-1).values
    return score, top2[..., 0] - top2[..., 1]


def near_boundary(score, margin, thresholds, k: int):
    """Rows [B] whose detections (the top-k cells) sit within NEAR_BAND
    of a decision boundary -> (a detection's score near one of
    `thresholds`, the score threshold rule; the k-th and (k+1)-th scores
    near each other (the top-k cut) or a detection's two classes near a
    tie)."""
    ranked = score.sort(dim=-1, descending=True).values
    kept = score >= ranked[:, k - 1:k]
    near_t = torch.zeros(score.shape[0], dtype=torch.bool,
                         device=score.device)
    for t in thresholds:
        near_t |= (((score - t).abs() < NEAR_BAND) & kept).any(-1)
    near_other = ((margin < NEAR_BAND) & kept).any(-1)
    if ranked.shape[1] > k:
        near_other |= ranked[:, k - 1] - ranked[:, k] < NEAR_BAND
    return near_t, near_other


def _keep_obs(args, kwargs, out):
    return _clone(out)


def _keep_raw(args, kwargs, out):
    cls_logits, _, obj_logits = args[1:]
    return tuple(x.cpu() for x in raw_scores(cls_logits, obj_logits))


def _check_detector_result(result, label) -> None:
    chosen = torch.tensor(result.chosen)
    acc = torch.tensor(result.acc_per_step)
    if (chosen.shape != (N_STEPS, N_CAMERAS)
            or not bool(((chosen >= 0) & (chosen < DEFAULT_GRID.n_cells))
                        .all())
            or not bool(torch.isfinite(acc).all())
            or not bool(((acc >= 0) & (acc <= 1)).all())):
        raise AssertionError(f"{label}: malformed result {result.chosen} "
                             f"{result.acc_per_step}")


def unfused_phase(spec: FleetRunSpec, frozen_steady_s: float) -> dict:
    """The unfused detector reference (fused=False) at the main path's
    cell, exhaustive (all N*Z windows, `chunk` of them a slab), and the
    fused path at shortlist_k = N*Z in the same call, both with the
    detector weights numpy draws from ANCHOR_SEED, each with the
    counters set to 0 just before and read just after: the unfused run
    launches oracle_pass, shape_search and budget_walk once per step and
    crop_patchify never, the fused run all four once per step; every
    recorded call equal to its plain version. Then the anchor: every
    cell's raw score (and class margin) of the two runs within
    NEAR_BAND; windows with a detection's score within NEAR_BAND of a
    threshold at most NEAR_SHARE of all; per window the two runs'
    observation tables agree (counts
    and nbox exact, areas within 1e-4) except where a detection sits
    within NEAR_BAND of a decision boundary (read from the fused run's
    raw scores: a threshold, the top-k cut, a class tie), and on at most
    NEAR_SHARE of the windows; each camera decides alike up to its first
    step that holds a differing window. Returns the runs' launch
    counts."""
    c = DEFAULT_GRID.n_cells * len(fleet_config(DEFAULT_GRID).zoom_levels)
    weights = detector_init(np.random.default_rng(ANCHOR_SEED),
                            spec.provider_kwargs["det_cfg"])
    anchor = {**spec.provider_kwargs, "det_params": weights,
              "thresh": FRESH_THRESH}
    unfused = dataclasses.replace(spec, shortlist_k=None, provider_kwargs={
        **anchor, "fused": False})
    fused = dataclasses.replace(spec, shortlist_k=c, provider_kwargs=anchor)
    steps = spec.n_steps + 1
    runs, paths = {}, {}
    for label, s, kernels in (
            ("unfused (fused=False)", unfused, UNFUSED_KERNELS),
            (f"fused, shortlist_k={c}", fused, MAIN_PATH_KERNELS)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with (SearchRecorder() as rec, OracleRecorder() as orec,
              PatchifyRecorder() as prec,
              CallRecorder(runner_module, "detections_obs",
                           _keep_obs) as obs,
              CallRecorder(detector_module, "_decode_detections",
                           _keep_raw) as raw):
            result = run_fleet(s)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        _launched_only(counts, kernels, steps, label)
        _check_detector_result(result, label)
        paths[label] = counts
        tag = f"[{label}]"
        oracle_phase(orec.calls, steps, tag)
        search_phase(rec.calls, steps, tag)
        if s is fused:
            patchify_phase(prec.calls, steps, tag)
        del rec, orec, prec
        t = result.timings
        print(f"{label}: {N_CAMERAS} cameras x {spec.n_steps} steps x {c} "
              f"windows: accuracy={result.accuracy:.6f} "
              f"frames_sent={list(result.frames_sent)} "
              f"compile_s={t['compile_s']:.3f} steady_s={t['steady_s']:.3f} "
              f"camera_steps_per_s={result.camera_steps_per_s:.2f} "
              f"peak_mem_gib={peak:.2f} (with the recorders' clones) "
              f"launches={counts} (over {spec.n_steps} steps + 1 warm-up "
              f"step)", flush=True)
        # one step's raw scores on the [F, C] window axis: the unfused
        # path decodes slab by slab (window = slab * chunk + j)
        per_step = len(raw.calls) // steps
        raw_steps = []
        for e in range(steps):
            parts = raw.calls[e * per_step:(e + 1) * per_step]
            raw_steps.append(tuple(
                torch.stack([x[i].reshape(N_CAMERAS, -1, x[i].shape[-1])
                             for x in parts], 1).reshape(N_CAMERAS, c, -1)
                for i in range(2)))
        # the episode's steps: the first recorded step is the warm-up
        runs[label] = dict(result=result, obs=obs.calls[1:],
                           raw=raw_steps[1:])

    (la, ua), (lb, fa) = runs.items()
    p = prepare_fleet_run(fused, device="cpu").provider
    thresholds = tuple(float(x) for x in p.thresh) + (float(p.geo_thresh),)
    k = p.det_cfg.max_boxes
    n_diff = n_near_t = n_near_other = 0
    area_err = score_err = margin_err = 0.0
    first = torch.full((N_CAMERAS,), spec.n_steps)
    for e in range(spec.n_steps):
        a, b = ua["obs"][e], fa["obs"][e]
        differ = ((a.counts != b.counts).any(-1)
                  | (a.nbox != b.nbox)
                  | ((a.areas - b.areas).abs() > 1e-4).any(-1))
        differ = differ.reshape(N_CAMERAS, c).cpu()
        score, margin = fa["raw"][e]
        score_err = max(score_err,
                        float((ua["raw"][e][0] - score).abs().max()))
        margin_err = max(margin_err,
                         float((ua["raw"][e][1] - margin).abs().max()))
        score, margin = score.reshape(-1, score.shape[-1]), margin.reshape(
            -1, margin.shape[-1])
        near_t, near_other = near_boundary(score, margin, thresholds, k)
        near_t = near_t.reshape(N_CAMERAS, c)
        near_other = near_other.reshape(N_CAMERAS, c)
        unexplained = differ & ~(near_t | near_other)
        if bool(unexplained.any()):
            where = torch.nonzero(unexplained)[:8].tolist()
            raise AssertionError(
                f"anchor step {e}: (camera, window) {where} differ between "
                f"the unfused and the fused run with no detection near a "
                f"decision boundary")
        rest = ~differ.reshape(a.areas.shape[:3]).to(a.areas.device)
        if bool(rest.any()):
            area_err = max(area_err, float(
                (a.areas - b.areas).abs().amax(-1)[rest].max()))
        n_diff += int(differ.sum())
        n_near_t += int(near_t.sum())
        n_near_other += int(near_other.sum())
        hit = differ.any(-1)
        first = torch.where(hit & (first == spec.n_steps), e, first)
    total = N_CAMERAS * c * spec.n_steps
    if n_near_t > NEAR_SHARE * total:
        raise AssertionError(
            f"anchor: {n_near_t} of {total} windows hold a detection within "
            f"{NEAR_BAND} of a threshold: over the {NEAR_SHARE:.1%} "
            f"allowed")
    if n_diff > NEAR_SHARE * total:
        raise AssertionError(
            f"anchor: {n_diff} of {total} windows differ: over the "
            f"{NEAR_SHARE:.1%} allowed")
    # the band must hold the two formulations' score differences
    if max(score_err, margin_err) >= NEAR_BAND:
        raise AssertionError(
            f"anchor: raw scores differ by {score_err:.3e} (class margins "
            f"by {margin_err:.3e}): not within {NEAR_BAND}")
    for f in range(N_CAMERAS):
        s = int(first[f])
        for name in ("explored", "order", "zooms", "sent", "chosen"):
            x = getattr(ua["result"].out, name)[:s, f]
            y = getattr(fa["result"].out, name)[:s, f]
            if not torch.equal(x, y):
                raise AssertionError(
                    f"anchor: camera {f} {name} differs before step {s}, "
                    f"its first step with a differing window")
    step0 = int(first.min())
    same = all(torch.equal(getattr(ua["result"].out, name),
                           getattr(fa["result"].out, name))
               for name in ("explored", "order", "zooms", "sent", "chosen"))
    w_sum = float(weights["backbone"]["vit"]["patch_embed"]["w"].sum())
    print(f"anchor ({la} against {lb}; weights numpy seed {ANCHOR_SEED}, "
          f"patch-embed sum {w_sum:.6f}): {n_diff} of {total} windows "
          f"differ in counts, nbox or areas (> 1e-4), each with a "
          f"detection within {NEAR_BAND} of a decision boundary; windows "
          f"with a detection's score within {NEAR_BAND} of a threshold: "
          f"{n_near_t} ({n_near_t / total:.2%}); near the top-{k} cut or "
          f"a class tie: {n_near_other} ({n_near_other / total:.2%}); raw "
          f"cell "
          f"scores max abs diff {score_err:.3e}, class margins "
          f"{margin_err:.3e}; areas on "
          f"the rest max abs err {area_err:.3e}; first step holding a "
          f"differing window: {step0 if step0 < spec.n_steps else 'none'}; "
          f"decisions (explored, order, zooms, sent, chosen) equal on the "
          f"{int(first.sum())} of {N_CAMERAS * spec.n_steps} camera-steps "
          f"before each camera's first differing window (on all: {same})",
          flush=True)
    ts = {k: v["result"].timings["steady_s"] for k, v in runs.items()}
    del runs
    render_ms, forward_ms = unfused_split(unfused)
    print(f"unfused step split (one step, card synchronised around each "
          f"part; ms): render {render_ms:.3f}, detector forward "
          f"{forward_ms:.3f} over {c // p.chunk} slabs of {N_CAMERAS} x "
          f"{p.chunk} crops; steady_s unfused={ts[la]:.3f} fused "
          f"exhaustive={ts[lb]:.3f} fused shortlist_k={SHORTLIST_K} (the "
          f"main path)={frozen_steady_s:.3f}; unfused / main path = "
          f"{ts[la] / frozen_steady_s:.2f}", flush=True)
    return paths


def unfused_split(spec: FleetRunSpec) -> tuple[float, float]:
    """One step of the unfused path's detector stage, apart: every slab
    rendered (render_fleet_crops), then every slab scored
    (detector_forward), host clock with the card synchronised around
    each part, warm (the second of two passes). -> (render ms, forward
    ms)."""
    prep = prepare_fleet_run(spec)
    p, st, cfg = prep.provider, prep.state, prep.cfg
    sc, dp = p.init_carry(st)
    kinds = torch.as_tensor(kind_mask(p.scene.spec), device=prep.device)
    res = p.det_cfg.img_res
    wins = p.scene.windows
    with torch.no_grad():
        sc1, _ = p.scene.oracle(cfg, prep.wl, sc, st)
        noise = render_noise(st.rng, st.step_idx * p.scene.stride,
                             res) * p.noise
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            crops = [render_fleet_crops(
                sc1.pos, sc1.size, kinds, sc1.oid, wins[i:i + p.chunk],
                res=res, min_visible=p.scene.spec.min_visible, noise=noise)
                for i in range(0, wins.shape[0], p.chunk)]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for x in crops:
                detector_module.detector_forward(
                    dp, p.det_cfg, x.reshape((-1,) + x.shape[2:]))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            del crops
    return (t1 - t0) * 1e3, (t2 - t1) * 1e3


def tables_phase(dev) -> dict:
    """materialize_scene_tables on the card: a homogeneous fleet of
    N_CAMERAS cameras (one scene seed), N_STEPS steps at 2 fps (shapes of
    several cells); its tables episode must decide exactly as the scene
    episode it recorded, pred_acc within 1e-6. Returns the launch counts
    of materialization, scene episode and tables episode together."""
    grid = DEFAULT_GRID
    cfg = fleet_config(grid, BudgetConfig(fps=2.0))
    wl_obj = FleetRunSpec().workload_obj()
    wl = workload_spec(wl_obj)
    provider, st = make_scene_provider(
        grid, wl_obj, cfg, n_cameras=N_CAMERAS, n_steps=N_STEPS,
        scene_seeds=[3] * N_CAMERAS, device=dev)
    statics = fleet_statics(grid, dev)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    tables = materialize_scene_tables(cfg, wl, statics, st, provider)
    torch.cuda.synchronize()
    mat_s = time.perf_counter() - t0
    with torch.no_grad():
        _, scene, _, _ = run_fleet_episode(cfg, wl, statics, st, provider)
        _, replay, _, _ = run_fleet_episode(cfg, wl, statics, st, tables)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {"oracle_pass": 2 * N_STEPS, "shape_search": 3 * N_STEPS,
            "budget_walk": 3 * N_STEPS}
    if {k: counts[k] for k in want} != want or any(
            v for k, v in counts.items() if k not in want):
        raise AssertionError(f"materialized tables: launches {counts}, "
                             f"want {want}")
    for name in ("explored", "order", "n_explored", "zooms", "sent",
                 "k_send", "chosen"):
        if not torch.equal(getattr(scene, name), getattr(replay, name)):
            raise AssertionError(f"materialized tables: {name} of the "
                                 f"tables episode differs from the scene "
                                 f"episode's")
    err = float((scene.pred_acc - replay.pred_acc).abs().max())
    if err > 1e-6:
        raise AssertionError(f"materialized tables: pred_acc differs by "
                             f"{err}")
    print(f"materialized tables: {N_CAMERAS} cameras of one scene seed x "
          f"{N_STEPS} steps at 2 fps, recorded in {mat_s:.3f} s; the "
          f"tables episode decides exactly as the scene episode (mean "
          f"shape {float(scene.n_explored.float().mean()):.2f} cells, "
          f"frames sent {int(scene.sent.sum())}); pred_acc max abs err "
          f"{err:.3e}; launches={counts} (materialization, scene episode, "
          f"tables episode)", flush=True)
    return counts


def _full_width_images(n: int, seed: int) -> torch.Tensor:
    """n cameras' first-window crops at madeye-approx's 224 px, with
    render noise, from a seeded scene (CPU)."""
    spec = SceneSpec()
    res = get_config("madeye-approx").img_res
    params, rng = scene_fleet_params(spec, n, seed=seed)
    sc = advance_scene(spec, params, rng, init_scene(spec, params, rng), 2,
                       4)
    kinds = torch.as_tensor(kind_mask(spec))
    wins = grid_windows(DEFAULT_GRID)
    crops = render_fleet_crops(sc.pos, sc.size, kinds, sc.oid,
                               wins[torch.arange(n) % wins.shape[0]][:, None],
                               res=res, noise=0.05 * render_noise(rng, 2,
                                                                  res))
    return crops[:, 0]


def engine_phase(dev) -> dict:
    """The serving engine on the card: run_fleet_detector_controller at
    ENGINE_CAMERAS cameras, ENGINE_STEPS steps (full width, shortlist
    18) decides exactly as run_fleet on the same spec; then
    InferenceEngine.counts_and_areas on N_CAMERAS full-width images
    against the CPU's: counts exact and areas within 1e-4 but on images
    with a detection within NEAR_BAND of a decision boundary. Returns
    the shim's launch counts."""
    full = get_config("madeye-approx")
    wl = FleetRunSpec().workload_obj()
    torch.cuda.synchronize()
    reset_counts()
    _, out = run_fleet_detector_controller(
        DEFAULT_GRID, wl, BudgetConfig(), n_cameras=ENGINE_CAMERAS,
        n_steps=ENGINE_STEPS, det_cfg=full, shortlist_k=SHORTLIST_K)
    torch.cuda.synchronize()
    counts = launch_counts()
    _launched_only(counts, MAIN_PATH_KERNELS, ENGINE_STEPS,
                   "run_fleet_detector_controller")
    res = run_fleet(FleetRunSpec(
        provider="detector", n_cameras=ENGINE_CAMERAS, n_steps=ENGINE_STEPS,
        shortlist_k=SHORTLIST_K, provider_kwargs={"det_cfg": full}))
    for name in ("explored", "order", "zooms", "sent", "chosen"):
        if not torch.equal(getattr(out, name), getattr(res.out, name)):
            raise AssertionError(f"run_fleet_detector_controller: {name} "
                                 f"differs from run_fleet's")
    print(f"run_fleet_detector_controller: {ENGINE_CAMERAS} cameras x "
          f"{ENGINE_STEPS} steps decide as run_fleet (chosen "
          f"{out.chosen.cpu().tolist()}); launches={counts}", flush=True)

    params = detector_init(torch.Generator().manual_seed(0), full)
    images = _full_width_images(N_CAMERAS, seed=4)
    thresh = 0.5
    on_card = InferenceEngine(full, params, dev).counts_and_areas(
        images, score_thresh=thresh)
    on_cpu = InferenceEngine(full, params, "cpu").counts_and_areas(
        images, score_thresh=thresh)
    with torch.no_grad():
        cls_logits, _, obj_logits = detector_raw(params, full, images)
    near_t, near_other = near_boundary(*raw_scores(cls_logits, obj_logits),
                                       (thresh,), full.max_boxes)
    differ = ((on_card[0].cpu() != on_cpu[0])
              | ((on_card[1].cpu() - on_cpu[1]).abs() > 1e-4))
    if bool((differ & ~(near_t | near_other)).any()):
        raise AssertionError("InferenceEngine: card and CPU differ on an "
                             "image with no detection near a boundary")
    area_err = float((on_card[1].cpu() - on_cpu[1]).abs()[~differ].max())
    print(f"InferenceEngine.counts_and_areas, {N_CAMERAS} images of "
          f"{full.img_res} px at score_thresh {thresh}: card and CPU "
          f"differ on {int(differ.sum())} images, each with a detection "
          f"within {NEAR_BAND} of a boundary (near the threshold: "
          f"{int(near_t.sum())}, the top-{full.max_boxes} cut or a class "
          f"tie: {int(near_other.sum())}); areas on the rest max abs err "
          f"{area_err:.3e}; counts {on_card[0].cpu().tolist()[:8]}...",
          flush=True)
    return counts


def continual_phase(dev) -> None:
    """The host continual-learning step on the card: FINETUNE_STEPS
    finetune_step calls at full width on 8 images, against the same on
    the CPU: the loss within 1e-4 relative each step, the backbone
    bit-unchanged."""
    full = get_config("madeye-approx")
    params = detector_init(torch.Generator().manual_seed(1), full)
    images = _full_width_images(8, seed=5)
    tgt = teacher_labels(
        [[[0.2 + 0.08 * i, 0.4, 0.2, 0.3], [0.7, 0.1 + 0.1 * i, 0.1, 0.1]]
         for i in range(8)], [[i % 2, 1] for i in range(8)],
        full.max_boxes)
    losses, times = {}, {}
    for d in ("cpu", dev):
        p = detector_module.params_from_numpy(params, d)
        backbone = [x.clone() for x in tree_leaves(p["backbone"])]
        opt = continual.init_finetune(p)
        args = [torch.as_tensor(x, device=d)
                for x in (images, tgt.boxes, tgt.classes, tgt.valid)]
        losses[str(d)] = []
        t0 = time.perf_counter()
        for _ in range(FINETUNE_STEPS):
            p, opt, loss = continual.finetune_step(p, opt, full, *args,
                                                   lr=3e-3)
            losses[str(d)].append(float(loss))
        times[str(d)] = (time.perf_counter() - t0) / FINETUNE_STEPS
        if not all(torch.equal(a, b)
                   for a, b in zip(backbone, tree_leaves(p["backbone"]))):
            raise AssertionError(f"finetune_step on {d}: the backbone "
                                 f"changed")
    card, cpu = torch.tensor(losses["cuda"]), torch.tensor(losses["cpu"])
    rel = float(((card - cpu).abs() / cpu.abs()).max())
    if rel > 1e-4 or not bool(torch.isfinite(card).all()):
        raise AssertionError(f"finetune_step: card loss {losses['cuda']} vs "
                             f"CPU {losses['cpu']}")
    print(f"host continual step: {FINETUNE_STEPS} finetune_step calls at "
          f"{full.img_res} px on 8 images: loss on the card "
          f"{[round(v, 6) for v in losses['cuda']]}, max rel err against "
          f"the CPU {rel:.3e}; backbone bit-unchanged; "
          f"{times['cuda'] * 1e3:.1f} ms a step on the card (host clock, "
          f"loss read back)", flush=True)


def examples_phase() -> None:
    """Each port example as `python -m repro_torch.examples.<name>` in a
    subprocess on the card, with small REPRO_EX_* overrides: exit 0 and
    its result line printed."""
    root = Path(__file__).resolve().parent
    for name, overrides, marker in EXAMPLES:
        env = dict(os.environ, **overrides)
        env["PYTHONPATH"] = str(root / "src") + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", f"repro_torch.examples.{name}"], env=env,
            cwd=root, capture_output=True, text=True, timeout=600)
        line = next((ln for ln in proc.stdout.splitlines() if marker in ln),
                    None)
        if proc.returncode != 0 or line is None:
            raise AssertionError(
                f"example {name}: exit {proc.returncode}\n"
                f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
        print(f"example {name} ({time.perf_counter() - t0:.1f} s): "
              f"{line.strip()}", flush=True)


def vit_flash_phase(spec: FleetRunSpec):
    """The ViT flash path on the main path's own crop_patchify tokens
    (its first step: F cameras x K shortlisted crops): the backbone with
    impl="flash" (counters set to 0 just before, read just after) and
    impl="xla", each through the neck, heads and decode. Returns (row,
    flash detections)."""
    prep = prepare_fleet_run(spec)
    p, st, cfg = prep.provider, prep.state, prep.cfg
    dc = p.det_cfg
    sc, dp = p.init_carry(st)
    dev = prep.device
    kinds = torch.as_tensor(kind_mask(p.scene.spec), device=dev)
    with torch.no_grad():
        sc1, _ = p.scene.oracle(cfg, prep.wl, sc, st)
        noise = render_noise(st.rng, st.step_idx * p.scene.stride,
                             dc.img_res) * p.noise
        tokens, _ = p._shortlist_tokens(cfg, st, sc1, dp, kinds, noise)
        tokens = tokens.reshape((-1,) + tokens.shape[2:])   # [F*K, P, D]
        vp = dp["backbone"]["vit"]

        def backbone(impl):
            return vit_features_tokens(vp, tokens, n_heads=dc.n_heads,
                                       impl=impl)

        torch.cuda.synchronize()
        reset_counts()
        feats_f = backbone("flash")
        torch.cuda.synchronize()
        counts = launch_counts()
        if counts["flash_attention"] != dc.n_layers or any(
                v for k, v in counts.items() if k != "flash_attention"):
            raise AssertionError(f"ViT flash path launches {counts}, want "
                                 f"flash_attention x {dc.n_layers} only")
        feats_x = backbone("xla")

        def detect(feats):
            return _decode_detections(dc, *head_outputs(
                dp["heads"], neck_features(dp["backbone"], feats)))

        det_f, det_x = detect(feats_f), detect(feats_x)
        torch.cuda.synchronize()
        # 6 layers of float32 attention summed in another order: 1e-4 on
        # features of order 1 and on scores in [0, 1]; boxes compared
        # where both pick the same cell (a near-tie may swap two cells)
        check_close("vit flash features", (feats_f,), (feats_x,), atol=1e-4)
        check_close("vit flash scores", (det_f.scores,), (det_x.scores,),
                    atol=1e-4)
        box_err = (det_f.boxes - det_x.boxes).abs().amax(-1)
        swapped = int((box_err > 1e-4).sum())
        if swapped > det_f.scores.numel() // 1000:
            raise AssertionError(f"vit flash boxes: {swapped} of "
                                 f"{det_f.scores.numel()} differ")
        ms_f = cuda_ms(lambda: backbone("flash"), 3)
        ms_x = cuda_ms(lambda: backbone("xla"), 3)
    row = dict(launches=counts["flash_attention"],
               feats_err=max_err((feats_f,), (feats_x,)),
               scores_err=max_err((det_f.scores,), (det_x.scores,)),
               boxes_swapped=swapped, backbone_flash_ms=ms_f,
               backbone_xla_ms=ms_x)
    print(f"vit flash path: tokens {tuple(tokens.shape)} "
          f"launches={counts} features max_abs_err={row['feats_err']:.3e} "
          f"scores max_abs_err={row['scores_err']:.3e} "
          f"boxes off by >1e-4: {swapped} of {det_f.scores.numel()} "
          f"backbone ms flash={ms_f:.3f} xla={ms_x:.3f}", flush=True)
    return row, det_f


def kernel_api_phase(dev, dets) -> dict:
    """The kernel APIs driven as a user calls them, counters set to 0
    just before and read just after: box_iou over one step's detections
    of N_BOX_CAMERAS cameras, nms_mask and match_boxes over 8 crops,
    frame_delta over one 1080p frame per camera, rmsnorm at stablelm-3b's
    width. NMS and matching must equal the CPU's; returns the counts."""
    boxes = dets.boxes[:N_BOX_CAMERAS * SHORTLIST_K].reshape(-1, 4)
    crops = dets.boxes[:8].contiguous(), dets.scores[:8].contiguous()
    cur, prev = delta_frames(N_CAMERAS, dev, 4)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(RMS_SHAPE, generator=gen, device=dev)
    wt = torch.ones(RMS_SHAPE[-1], device=dev)

    def nms_and_match(bx, sc):
        keep = [nms_mask(bx[i], sc[i], sc[i] > 0) for i in range(8)]
        match = [match_boxes(bx[i], bx[(i + 1) % 8],
                             sc[(i + 1) % 8] > sc[(i + 1) % 8].median(),
                             iou_thresh=0.3) for i in range(8)]
        return keep, match

    torch.cuda.synchronize()
    reset_counts()
    iou = box_iou(boxes, boxes)
    keep, match = nms_and_match(*crops)
    deltas = [frame_delta(cur[i], prev[i]) for i in range(N_CAMERAS)]
    y = rmsnorm(x, wt)
    torch.cuda.synchronize()
    counts = launch_counts()

    want = {"box_iou": 1 + 16, "frame_delta": N_CAMERAS, "rmsnorm": 1}
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"kernel API launches {counts}, want {want}")
    keep_c, match_c = nms_and_match(*(t.cpu() for t in crops))
    same = all(torch.equal(a.cpu(), b) for a, b in zip(keep, keep_c))
    same &= all(torch.equal(a.cpu(), b) for m, mc in zip(match, match_c)
                for a, b in zip(m, mc))
    if not same:
        raise AssertionError("nms_mask / match_boxes: card != CPU")
    fd = [check_frame_delta(cur[i], prev[i], *deltas[i][:2],
                            f"frame_delta[{i}]") for i in range(N_CAMERAS)]
    diag = torch.diagonal(iou)[dets.scores[:N_BOX_CAMERAS
                                           * SHORTLIST_K].reshape(-1) > 0]
    sent = torch.stack([d[1].sum() for d in deltas])
    if not (bool(((diag - 1).abs() < 1e-5).all())
            and bool(torch.isfinite(y).all())
            and all(int(d[2]) > 0 for d in deltas)):
        raise AssertionError("kernel API outputs malformed")
    print(f"kernel APIs: launches={counts} boxes={boxes.shape[0]} "
          f"kept per crop={[int(k.sum()) for k in keep]} "
          f"matched per crop={[int(m[0].sum()) for m in match]} "
          f"changed tiles per frame (mean)={float(sent.float().mean()):.1f}"
          f" of {deltas[0][1].numel()}, flipped against the plain version "
          f"{sum(f for _, f in fd)} (max |int8 difference| "
          f"{max(e for e, _ in fd)})", flush=True)

    # after the counted run: box_iou on the same detections (boxes of
    # one image space, so most pairs intersect: the case to judge the
    # kernel by), and nms_mask / match_boxes per call over one crop's 32
    # boxes and over 18 crops' 576
    box_iou_row(boxes, boxes, "one step's detections")
    flat = dets.boxes[:SHORTLIST_K].reshape(-1, 4).contiguous()
    flat_sc = dets.scores[:SHORTLIST_K].reshape(-1).contiguous()
    times = []
    for bx, sc in ((crops[0][0], crops[1][0]), (flat, flat_sc)):
        nv = sc > 0
        nms = cuda_ms(lambda: nms_mask(bx, sc, nv), 3)
        match = cuda_ms(lambda: match_boxes(bx, bx.flip(0), nv,
                                            iou_thresh=0.3), 3)
        times.append(f"N={bx.shape[0]}: nms_mask {nms:.3f} ms, "
                     f"match_boxes {match:.3f} ms")
    print("nms_mask / match_boxes per call (CUDA events, one box_iou "
          "launch + N PyTorch rounds each): " + "; ".join(times),
          flush=True)
    return counts


# ---------------------------------------------------------------------------
# phase 8d: the LM half of the model zoo (PR 20)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def exact_bf16():
    """bf16 products reduce in float32 inside the block (cuBLAS may
    otherwise reduce in bf16), so card-vs-card and card-vs-CPU
    comparisons see only the rounding the model asks for."""
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            saved


def counted(fn, keep_dense: bool = False):
    """(fn(), the kernels it launched {name: n}): the counters set to 0
    just before, read just after (dense too where `keep_dense`)."""
    torch.cuda.synchronize()
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in launch_counts(
        keep_dense=keep_dense).items() if v}


def expect_launches(got: dict, want: dict, label: str) -> None:
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def near_tie_argmax(got, want, margin: float) -> tuple[int, int]:
    """(positions where want's top-2 logits are more than `margin` apart,
    those of them whose argmax differs)."""
    top2 = want.float().topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > margin
    differ = got.float().argmax(-1) != want.float().argmax(-1)
    return int(sure.sum()), int((sure & differ).sum())


def rel_rms(got, want) -> float:
    d = (got.float() - want.float()).square().mean().sqrt()
    return float(d / want.float().square().mean().sqrt())


def lm_dense_f32(dev) -> tuple[dict, dict]:
    """stablelm-3b at full width and depth in float32: lm_forward with
    impl="flash" and "xla" over LM_BATCH x (LM_PROMPT + LM_CONT) tokens,
    gqa_prefill over the prompts, LM_CONT teacher-forced decode steps;
    counters from 0 around each call. Returns (launches by path, the
    float32 weights). The forwards and the prefill launch dense once per
    linear (LM_LINEARS); a decode step's LM_BATCH rows are below
    layers.DENSE_MIN_ROWS and launch nothing."""
    cfg = dataclasses.replace(get_config(LM_DENSE_ARCH), dtype=torch.float32)
    n, p = LM_PROMPT + LM_CONT, LM_PROMPT
    gen = torch.Generator(device=dev).manual_seed(LM_SEED)
    params = lm_init(gen, cfg, device=dev)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, n), generator=gen,
                         device=dev)
    dense_n = {DENSE_KERNEL: LM_LINEARS * cfg.n_layers + 1}
    launches = {}
    fl, c = counted(lambda: lm_forward(params, cfg, toks, impl="flash"),
                    keep_dense=True)
    expect_launches(c, {"flash_attention": cfg.n_layers} | dense_n,
                    "flash forward")
    launches["stablelm-3b f32 forward flash"] = c.get("flash_attention", 0)
    xl, c = counted(lambda: lm_forward(params, cfg, toks, impl="xla"),
                    keep_dense=True)
    expect_launches(c, dense_n, "xla forward")
    scale = float(xl.abs().max())
    tol = LM_F32_REL * scale
    err_fx = float((fl - xl).abs().max())
    sure, flips = near_tie_argmax(fl, xl, tol)
    del fl
    (pl, cache), c = counted(lambda: gqa_prefill(params, cfg, toks[:, :p],
                                                 max_seq=n),
                             keep_dense=True)
    expect_launches(c, dense_n, "gqa_prefill")
    err_px = float((pl - xl[:, :p]).abs().max())
    del pl
    dec_err, dec_rel, dec_sure, dec_flips = [], [], 0, 0
    for i in range(p, n):
        (dl, cache), c = counted(lambda: gqa_decode_step(
            params, cfg, toks[:, i:i + 1], cache), keep_dense=True)
        expect_launches(c, {}, f"gqa_decode_step {i}")
        dec_err.append(float((dl[:, 0] - xl[:, i]).abs().max()))
        dec_rel.append(rel_rms(dl[:, 0], xl[:, i]))
        s, f = near_tie_argmax(dl[:, 0], xl[:, i], LM_DECODE_TOL)
        dec_sure, dec_flips = dec_sure + s, dec_flips + f
    print(f"lm stablelm-3b f32 [{LM_BATCH} x {n}]: launches flash="
          f"{cfg.n_layers} xla/prefill/decode=0, dense "
          f"{dense_n[DENSE_KERNEL]} a forward and prefill, 0 a decode step; "
          f"|logits| max {scale:.3f}; "
          f"flash vs xla max_abs_err={err_fx:.3e} (tol {tol:.3e}), argmax "
          f"differs at {flips} of {sure} clear positions; prefill vs "
          f"forward {err_px:.3e}; decode vs forward max_abs_err "
          f"{max(dec_err):.3e} (tol {LM_DECODE_TOL}), rel rms "
          f"{max(dec_rel):.3e}, argmax differs at {dec_flips} of {dec_sure} "
          f"clear positions; per step {[f'{e:.2e}' for e in dec_err]}",
          flush=True)
    if err_fx > tol or err_px > tol or flips:
        raise AssertionError("stablelm-3b f32: flash or prefill vs forward "
                             "out of tolerance")
    if max(dec_err) > LM_DECODE_TOL or dec_flips:
        raise AssertionError("stablelm-3b f32: decode vs forward out of "
                             "tolerance")
    launches["stablelm-3b f32 forward xla, prefill, decode"] = 0
    return launches, params


def lm_dense_bf16(dev, params) -> dict:
    """stablelm-3b at its published bf16 (the float32 run's weights
    cast), timed: prefill (last_only), LM_CONT decode steps at batch
    LM_BATCH, the forward with flash and xla; peak memory."""
    cfg = get_config(LM_DENSE_ARCH)
    n, p = LM_PROMPT + LM_CONT, LM_PROMPT
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    toks = torch.randint(0, cfg.vocab, (LM_BATCH, n), generator=gen,
                         device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = cuda_ms(lambda: gqa_prefill(params, cfg, toks[:, :p],
                                             max_seq=n, last_only=True), 3)
    _, cache = gqa_prefill(params, cfg, toks[:, :p], max_seq=n,
                           last_only=True)

    def decode_all():
        c = cache
        for i in range(p, n):
            _, c = gqa_decode_step(params, cfg, toks[:, i:i + 1], c)

    decode_ms = cuda_ms(decode_all, 2) / LM_CONT
    fwd_ms = {impl: cuda_ms(lambda: lm_forward(params, cfg, toks, impl=impl),
                            2) for impl in ("flash", "xla")}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    row = {"prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
           "decode_tokens_per_s": LM_BATCH * 1e3 / decode_ms,
           "forward_flash_ms": fwd_ms["flash"], "forward_xla_ms": fwd_ms["xla"],
           "peak_gib": peak}
    print(f"lm stablelm-3b bf16: prefill [{LM_BATCH} x {p}] last_only "
          f"{prefill_ms:.2f} ms; decode {decode_ms:.2f} ms a step at batch "
          f"{LM_BATCH} ({row['decode_tokens_per_s']:.1f} tokens/s, "
          f"{LM_CONT} steps from {p}); forward [{LM_BATCH} x {n}] flash "
          f"{fwd_ms['flash']:.2f} ms, xla {fwd_ms['xla']:.2f} ms; peak "
          f"{peak:.2f} GiB", flush=True)
    return row


class MoERecorder(CallRecorder):
    """While active, keeps (layer params, input clone, MoEMetrics) of
    every moe_ffn call (the name moe_lm and kvcache look up)."""

    def __init__(self):
        super().__init__(moe_module, "moe_ffn",
                         lambda a, k, out: (a[0], a[1].clone(), a[2],
                                            out[1]))


def _treated(call, capacity_factor: float) -> torch.Tensor:
    """How one recorded moe_ffn call treated each token, recomputed from
    its input: its (expert, kept) pairs, sorted [T, K] (as 2 * expert +
    kept)."""
    p, x, cfg, _ = call
    ids = moe_module.router_topk(p["router"]["w"], x.reshape(-1, x.shape[-1]),
                                 cfg.moe_top_k)[1]
    c = moe_module.capacity(ids.shape[0], cfg, capacity_factor)
    order, _, _, keep = moe_module.moe_dispatch(ids, c)
    kept = torch.empty_like(keep)
    kept[order] = keep
    return (2 * ids + kept.reshape(ids.shape)).sort(-1).values


def _alike(a, b) -> torch.Tensor:
    """Tokens the MoE layer treated alike in two runs: the same experts,
    the same of them kept."""
    return (a == b).all(-1)


def _bf16_compare(got, want, alike, label: str) -> dict:
    """max |got - want| over the tokens treated alike ([B, S] mask) and
    the argmax there wherever want's top-2 margin exceeds LM_BF16_ABS."""
    g, w = got.float()[alike], want.float()[alike]
    err = float((g - w).abs().max()) if g.numel() else 0.0
    sure, flips = near_tie_argmax(g, w, LM_BF16_ABS)
    if err > LM_BF16_ABS or flips:
        raise AssertionError(f"deepseek-v3 bf16 {label}: max_abs_err "
                             f"{err:.3e} (tol {LM_BF16_ABS}), argmax "
                             f"differs at {flips} of {sure}")
    return {"tokens": int(alike.sum()), "of": alike.numel(),
            "max_abs_err": err, "rel_rms": rel_rms(g, w),
            "argmax_checked": sure}


def lm_moe_bf16(dev) -> dict:
    """deepseek-v3 at full width, depth cut to LM_MOE_LAYERS (its first
    3 dense layers and 1 MoE layer), bf16, LM_MOE_BATCH x LM_MOE_SEQ
    tokens, the last LM_MOE_DECODE decoded. The forward over the prompt
    as configured (capacity factor 1.25) gives dropped_frac and the
    reference for mla_prefill over the same tokens; the forward with
    flash (MLA heads of 192, v padded) and xla over all tokens runs at
    capacity factor E / K, room for every assignment, which is what the
    decode steps (one token an expert queue, never dropped) are held
    against. Each comparison covers the tokens the MoE layer treated
    alike in both runs, the same experts and the same of them kept (a
    near tie at the top-8 boundary sends a token elsewhere). Also the
    MoE layer's ms and peak memory."""
    cfg = dataclasses.replace(get_config(LM_MOE_ARCH),
                              n_layers=LM_MOE_LAYERS)
    n, p = LM_MOE_SEQ, LM_MOE_SEQ - LM_MOE_DECODE
    no_drop = cfg.moe_experts / cfg.moe_top_k
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 2)
    params = moe_lm_init(gen, cfg, device=dev)
    toks = torch.randint(0, cfg.vocab, (LM_MOE_BATCH, n), generator=gen,
                         device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches, out = {}, {}
    with exact_bf16():
        with MoERecorder() as rc:
            (cl, _), c = counted(lambda: moe_lm_forward(params, cfg,
                                                        toks[:, :p]))
        expect_launches(c, {}, "moe xla forward")
        with MoERecorder() as rf:
            (fl, _), c = counted(lambda: moe_lm_forward(
                params, cfg, toks, impl="flash", capacity_factor=no_drop))
        expect_launches(c, {"flash_attention": cfg.n_layers}, "moe flash")
        launches["deepseek-v3 bf16 forward flash"] = c.get("flash_attention", 0)
        with MoERecorder() as rx:
            (xl, _), c = counted(lambda: moe_lm_forward(
                params, cfg, toks, capacity_factor=no_drop))
        expect_launches(c, {}, "moe xla forward")
        shape = (LM_MOE_BATCH, n)
        tx = _treated(rx.calls[0], no_drop)
        out["flash vs xla"] = _bf16_compare(
            fl, xl, _alike(_treated(rf.calls[0], no_drop), tx).reshape(
                shape), "flash vs xla")
        del fl
        with MoERecorder() as rp:
            (pl, cache), c = counted(lambda: mla_prefill(
                params, cfg, toks[:, :p], max_seq=n))
        expect_launches(c, {}, "mla_prefill")
        out["prefill vs forward"] = _bf16_compare(
            pl, cl, _alike(_treated(rp.calls[0], 1.25),
                           _treated(rc.calls[0], 1.25)).reshape(
                LM_MOE_BATCH, p), "prefill vs forward")
        del pl
        dec, dec_alike = [], []
        tx_pos = tx.reshape(LM_MOE_BATCH, n, -1)
        for i in range(p, n):
            with MoERecorder() as rd:
                (dl, cache), c = counted(lambda: mla_decode_step(
                    params, cfg, toks[:, i:i + 1], cache))
            expect_launches(c, {}, f"mla_decode_step {i}")
            dec.append(dl[:, 0])
            dec_alike.append(_alike(_treated(rd.calls[0], 1.25),
                                    tx_pos[:, i]))
        out["decode vs forward"] = _bf16_compare(
            torch.stack(dec, 1), xl[:, p:], torch.stack(dec_alike, 1),
            "decode vs forward")
    dropped = float(rc.calls[0][3].dropped_frac)
    lp, x_moe = rc.calls[0][0], rc.calls[0][1]
    moe_ms = cuda_ms(lambda: moe_module.moe_ffn(lp, x_moe, cfg), 5)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = count_params(params)
    print(f"lm deepseek-v3 bf16 (depth cut to {cfg.n_layers}: "
          f"{cfg.first_dense_layers} dense + "
          f"{cfg.n_layers - cfg.first_dense_layers} MoE, "
          f"{n_params / 1e9:.2f}B parameters) [{LM_MOE_BATCH} x {n}]: "
          f"launches flash={cfg.n_layers} xla/prefill/decode=0; "
          + "; ".join(f"{k} on {v['tokens']} of {v['of']} tokens treated "
                      f"alike: max_abs_err {v['max_abs_err']:.3e} rel rms "
                      f"{v['rel_rms']:.3e}, argmax equal at "
                      f"{v['argmax_checked']} clear positions"
                      for k, v in out.items())
          + f" (tol {LM_BF16_ABS}); dropped_frac at capacity factor 1.25 "
          f"over {LM_MOE_BATCH} x {p} tokens {dropped:.4f}; MoE layer "
          f"{moe_ms:.3f} ms; peak {peak:.2f} GiB",
          flush=True)
    launches["deepseek-v3 bf16 forward xla, prefill, decode"] = 0
    del params, cache, xl, cl
    return {"launches": launches, "dropped_frac": dropped,
            "moe_layer_ms": moe_ms, "peak_gib": peak, "compare": out}


def _lm_fns(cfg):
    """(forward -> logits, prefill, decode step) of an LM config."""
    if cfg.mla:
        return (lambda p, t: moe_lm_forward(p, cfg, t)[0], mla_prefill,
                mla_decode_step)
    if cfg.moe_experts is not None:
        return (lambda p, t: moe_lm_forward(p, cfg, t)[0], moe_gqa_prefill,
                moe_gqa_decode_step)
    return (lambda p, t: lm_forward(p, cfg, t), gqa_prefill,
            gqa_decode_step)


def _lm_run(cfg, params, toks):
    """Forward, prefill and decode logits of a smoke config: a float32
    model decodes every token from an empty float32 cache (no bf16
    rounding of k/v, which two devices may round to neighbouring bf16
    values), a bf16 model from its prefill's cache."""
    fwd, pre, dec = _lm_fns(cfg)
    out = [fwd(params, toks)]
    logits, cache = pre(params, cfg, toks[:, :LM_SMALL_PROMPT],
                        max_seq=toks.shape[1])
    out.append(logits)
    start = LM_SMALL_PROMPT
    if cfg.dtype == torch.float32:
        init = init_mla_cache if cfg.mla else init_gqa_cache
        cache = init(cfg, toks.shape[0], toks.shape[1], dtype=torch.float32,
                     device=toks.device)
        start = 0
    for i in range(start, toks.shape[1]):
        logits, cache = dec(params, cfg, toks[:, i:i + 1], cache)
        out.append(logits)
    return out


def lm_small_parity(dev) -> None:
    """The four SMOKE configs on the card and on the CPU, weights drawn
    by numpy (the same under any PyTorch): forward, prefill and decode
    logits within LM_SMALL_TOL; the MoE router's ids on one input, and
    the dispatch plan, equal but at a near tie."""
    worst = {}
    with torch.no_grad(), exact_bf16():
        for arch in LM_ARCHS:
            for dtype in (torch.float32, torch.bfloat16):
                cfg = dataclasses.replace(get_smoke_config(arch),
                                          dtype=dtype)
                init = moe_lm_init if cfg.moe_experts else lm_init
                cpu_p = init(np.random.default_rng(0), cfg, device="cpu")
                toks = torch.as_tensor(np.random.default_rng(1).integers(
                    0, cfg.vocab, (2, LM_SMALL_PROMPT + 4)))
                want = _lm_run(cfg, cpu_p, toks)
                got = _lm_run(cfg, tree_map(lambda t: t.to(dev), cpu_p),
                              toks.to(dev))
                err = max(float((g.cpu().float() - w.float()).abs().max())
                          for g, w in zip(got, want))
                tol = LM_SMALL_TOL[dtype]
                worst[f"{arch} {str(dtype)[6:]}"] = err
                if err > tol:
                    raise AssertionError(f"lm {arch} {dtype}: card vs CPU "
                                         f"{err:.3e} > {tol}")
                if cfg.moe_experts and dtype == torch.float32:
                    _router_parity(cfg, cpu_p, dev)
    print("lm small input, card vs CPU (max abs err of forward, prefill "
          "and decode logits): " + ", ".join(
              f"{k} {v:.2e}" for k, v in worst.items())
          + f"; routing equal but at near ties (gap < {LM_TIE_GAP})",
          flush=True)


def _router_parity(cfg, cpu_p, dev) -> None:
    """The first MoE layer's router and dispatch plan on one float32
    input [2, 16, D], card vs CPU: ids equal but at a near tie (top-k
    boundary gap under LM_TIE_GAP), then order, positions and keep
    equal."""
    lp = layer_params(cpu_p["moe_layers"], 0)["moe"]
    x = torch.as_tensor(np.random.default_rng(2).normal(
        0, 1, (32, cfg.d_model)).astype(np.float32))
    k = cfg.moe_top_k
    _, ids_c, probs = moe_module.router_topk(lp["router"]["w"], x, k)
    _, ids_g, _ = moe_module.router_topk(lp["router"]["w"].to(dev),
                                         x.to(dev), k)
    srt = probs.sort(-1, descending=True).values
    gap = (srt[:, :k] - srt[:, 1:k + 1]).min(-1).values
    differ = (ids_g.cpu() != ids_c).any(-1)
    if bool((differ & (gap >= LM_TIE_GAP)).any()):
        raise AssertionError(f"{cfg.name}: router ids differ away from a "
                             f"near tie")
    c = moe_module.capacity(x.shape[0], cfg, 0.5)
    plan_c = moe_module.moe_dispatch(ids_c, c)
    plan_g = moe_module.moe_dispatch(ids_c.to(dev), c)
    for a, b in zip(plan_c, plan_g):
        if not torch.equal(a, b.cpu()):
            raise AssertionError(f"{cfg.name}: dispatch plan differs")


def _row_json(rows: dict) -> dict:
    """Kernel rows measured at a model's shapes, as the JSON line
    carries them."""
    return {label: {"max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
                    "bound_by": r["bound"][1], "library_ms": r["library_ms"]}
            for label, r in rows.items()}


def lm_phase(dev) -> dict:
    """Phase 8d. Returns the flash_attention launches by LM path, the
    timings, and the two LM flash rows."""
    t0 = time.perf_counter()
    with torch.no_grad():
        launches, params = lm_dense_f32(dev)
        params = cast_floats(params, torch.bfloat16)
        torch.cuda.empty_cache()
        dense = lm_dense_bf16(dev, params)
        del params
        torch.cuda.empty_cache()
        flash_dense = flash_case(dev, LM_BATCH, LM_PROMPT + LM_CONT,
                                 LM_PROMPT + LM_CONT, 32, 32, 80,
                                 causal=True, dtype=torch.bfloat16,
                                 library=True)
        moe = lm_moe_bf16(dev)
        torch.cuda.empty_cache()
        flash_moe = flash_case(dev, LM_MOE_BATCH, LM_MOE_SEQ, LM_MOE_SEQ,
                               128, 128, 192, causal=True,
                               dtype=torch.bfloat16, library=True)
    launches.update(moe["launches"])
    lm_small_parity(dev)
    print(f"lm phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"launches": launches, "dense": dense, "moe": moe,
            "rows": {"[4, 2064, 32, 80] causal bf16 (stablelm-3b)":
                     flash_dense,
                     "[2, 512, 128, 192] causal bf16 (deepseek-v3 MLA)":
                     flash_moe}}


# ---------------------------------------------------------------------------
# phase 8e: the vision and diffusion half of the model zoo
# ---------------------------------------------------------------------------

def wake_zero_init(params, gen, std: float = ZOO_WAKE_STD) -> None:
    """Draw the zero-initialised adaLN linears and final projections of
    a DiT / MMDiT tree from N(0, std) in place (at zero every block is
    the identity and the output 0)."""
    for k, v in params.items():
        if isinstance(v, dict):
            if "w" in v and ("ada" in k or k == "final_proj"):
                v["w"].normal_(0.0, std, generator=gen)
            else:
                wake_zero_init(v, gen, std)


def once_ms(fn) -> float:
    """Device time of one call of fn() (already warm), by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def zoo_vit(dev, arch: str) -> dict:
    """One ViT at full width and depth: float32 impl="flash" vs "xla" at
    batch ZOO_F32_BATCH within LM_F32_REL x max |logit|, then the same
    weights in bf16 at serve_b128, each impl timed; counters from 0
    around every forward (flash_attention once per layer with flash,
    nothing with xla)."""
    cfg32 = dataclasses.replace(get_config(arch), dtype=torch.float32)
    n, res = cfg32.n_layers, cfg32.img_res
    gen = torch.Generator(device=dev).manual_seed(ZOO_SEED)
    params = vit_module.vit_init(gen, cfg32, device=dev)
    img = torch.rand(ZOO_F32_BATCH, res, res, 3, generator=gen, device=dev)
    flash = {"flash_attention": n}
    with full_float32():
        fl, c = counted(lambda: vit_module.vit_forward(params, cfg32, img,
                                                       impl="flash"))
        expect_launches(c, flash, f"{arch} f32 flash forward")
        xl, c = counted(lambda: vit_module.vit_forward(params, cfg32, img,
                                                       impl="xla"))
        expect_launches(c, {}, f"{arch} f32 xla forward")
    scale = float(xl.abs().max())
    tol = LM_F32_REL * scale
    err = float((fl - xl).abs().max())
    if err > tol or not bool(torch.isfinite(fl).all()):
        raise AssertionError(f"{arch} f32 flash vs xla {err:.3e} > {tol:.3e}")
    cfg = get_config(arch)
    params = cast_floats(params, cfg.dtype)
    imgs = torch.rand(ZOO_SERVE_BATCH, res, res, 3, generator=gen,
                      device=dev)
    logits, ms = {}, {}
    for impl in ("flash", "xla"):
        logits[impl], c = counted(lambda: vit_module.vit_forward(
            params, cfg, imgs, impl=impl))
        expect_launches(c, flash if impl == "flash" else {},
                        f"{arch} bf16 {impl} forward")
        ms[impl] = cuda_ms(lambda: vit_module.vit_forward(
            params, cfg, imgs, impl=impl), 3)
    rr = rel_rms(logits["flash"], logits["xla"])
    if rr > ZOO_BF16_REL_RMS or not bool(torch.isfinite(
            logits["flash"]).all()):
        raise AssertionError(f"{arch} bf16 flash vs xla rel rms {rr:.3e}")
    n_params = count_params(params)
    print(f"zoo {arch} ({n_params / 1e6:.1f}M parameters, {n} layers): "
          f"launches flash={n} xla=0 a forward; f32 [{ZOO_F32_BATCH}] "
          f"flash vs xla max_abs_err={err:.3e} (tol {tol:.3e}, |logits| "
          f"max {scale:.3f}); bf16 [{ZOO_SERVE_BATCH}] flash "
          f"{ms['flash']:.2f} ms ({ZOO_SERVE_BATCH * 1e3 / ms['flash']:.1f} "
          f"images/s), xla {ms['xla']:.2f} ms "
          f"({ZOO_SERVE_BATCH * 1e3 / ms['xla']:.1f} images/s), flash vs "
          f"xla rel rms {rr:.3e}", flush=True)
    return {"launches": {f"{arch} f32 forward flash": n,
                         f"{arch} bf16 forward flash": n,
                         f"{arch} f32 and bf16 forward xla": 0},
            "params": n_params, "f32_err": err, "f32_tol": tol,
            "bf16_rel_rms": rr, "flash_ms": ms["flash"], "xla_ms": ms["xla"]}


def zoo_swin(dev) -> dict:
    """Swin-B at full width and depth, bf16: a forward at serve_b128
    timed; one at 384 px (batch ZOO_384_BATCH), where window 7 divides no
    stage's map and each takes window 12. No kernel launches."""
    cfg = get_config("swin-b")
    gen = torch.Generator(device=dev).manual_seed(ZOO_SEED + 1)
    params = swin_module.swin_init(gen, cfg, device=dev)
    imgs = torch.rand(ZOO_SERVE_BATCH, cfg.img_res, cfg.img_res, 3,
                      generator=gen, device=dev)
    out, c = counted(lambda: swin_module.swin_forward(params, cfg, imgs))
    expect_launches(c, {}, "swin-b forward")
    ms = cuda_ms(lambda: swin_module.swin_forward(params, cfg, imgs), 3)
    res = 384
    windows = [swin_module._effective_window(res // cfg.patch // 2 ** i,
                                             cfg.window)
               for i in range(len(cfg.depths))]
    img384 = torch.rand(ZOO_384_BATCH, res, res, 3, generator=gen,
                        device=dev)
    out384, c = counted(lambda: swin_module.swin_forward(params, cfg,
                                                         img384))
    expect_launches(c, {}, "swin-b 384 forward")
    ms384 = once_ms(lambda: swin_module.swin_forward(params, cfg, img384))
    for o, b in ((out, ZOO_SERVE_BATCH), (out384, ZOO_384_BATCH)):
        if o.shape != (b, cfg.n_classes) or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"swin-b logits {tuple(o.shape)} not finite "
                                 f"or of the wrong shape")
    n_params = count_params(params)
    print(f"zoo swin-b ({n_params / 1e6:.1f}M parameters, depths "
          f"{cfg.depths}): bf16 [{ZOO_SERVE_BATCH}, 224 px] {ms:.2f} ms "
          f"({ZOO_SERVE_BATCH * 1e3 / ms:.1f} images/s); [{ZOO_384_BATCH}, "
          f"384 px] windows by stage {windows} {ms384:.2f} ms; no kernel",
          flush=True)
    return {"params": n_params, "ms": ms, "ms_384": ms384,
            "windows_384": windows}


def zoo_dit(dev) -> dict:
    """DiT-L/2 at full width and depth: a float32 forward at 256 px
    (latent 32, its trained grid) against the bf16 forward of the same
    weights (relative RMS), then dit_sample in bf16 at gen_fast (latent
    64: the learned 16 x 16 pos_embed resized to 32 x 32 on the card),
    ms a step and peak memory. No kernel launches."""
    cfg = get_config("dit-l2")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(ZOO_SEED + 2)
    params = dit_module.dit_init(gen, cfg32, device=dev)
    wake_zero_init(params, gen)
    r0 = cfg.img_res // 8
    lat = torch.randn(ZOO_DIT_F32_BATCH, r0, r0, cfg.latent_channels,
                      generator=gen, device=dev)
    t = torch.tensor([10.0, 700.0], device=dev)
    y = torch.tensor([3, cfg.n_classes], device=dev)
    with full_float32():
        want = dit_module.dit_forward(params, cfg32, lat, t, y)
    params = cast_floats(params, cfg.dtype)
    got = dit_module.dit_forward(params, cfg, lat, t, y)
    rr = rel_rms(got, want)
    if rr > ZOO_BF16_REL_RMS or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"dit-l2 bf16 vs f32 rel rms {rr:.3e}")
    r = ZOO_GEN_RES // 8
    key = prng.PRNGKey(ZOO_SEED, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def sample():
        return diffusion_module.dit_sample(
            params, cfg, key, batch=ZOO_GEN_BATCH, n_steps=ZOO_GEN_STEPS,
            latent_res=r)

    x, c = counted(sample)
    expect_launches(c, {}, "dit_sample")
    step_ms = once_ms(sample) / ZOO_GEN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if x.shape != (ZOO_GEN_BATCH, r, r, cfg.latent_channels) or not bool(
            torch.isfinite(x).all()):
        raise AssertionError("dit_sample latents not finite or of the "
                             "wrong shape")
    n_params = count_params(params)
    print(f"zoo dit-l2 ({n_params / 1e6:.1f}M parameters): bf16 vs f32 "
          f"forward [{ZOO_DIT_F32_BATCH}, latent {r0}] rel rms {rr:.3e} "
          f"(tol {ZOO_BF16_REL_RMS}); dit_sample gen_fast [{ZOO_GEN_BATCH}"
          f", latent {r}, {(r // cfg.patch) ** 2} tokens, {ZOO_GEN_STEPS} "
          f"steps] {step_ms:.2f} ms a step, |x| max "
          f"{float(x.abs().max()):.3e}, peak {peak:.2f} GiB; no kernel",
          flush=True)
    return {"params": n_params, "bf16_rel_rms": rr, "step_ms": step_ms,
            "peak_gib": peak}


def zoo_flux(dev) -> dict:
    """Flux-dev MMDiT at full width and depth, bf16: rf_sample at
    gen_fast (latent 64: 1,024 image tokens + 128 text tokens from seeded
    embeddings), ms a step, peak memory (at most ZOO_PEAK_GIB) and the
    parameter count. No kernel launches."""
    cfg = get_config("flux-dev")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(ZOO_SEED + 3)
    params = mmdit_module.mmdit_init(gen, cfg, device=dev)
    wake_zero_init(params, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    r = ZOO_GEN_RES // 8
    txt = torch.randn(ZOO_GEN_BATCH, mmdit_module.TXT_TOKENS, cfg.cond_dim,
                      generator=gen, device=dev)
    key = prng.PRNGKey(ZOO_SEED + 3, device=dev)

    def sample():
        return diffusion_module.rf_sample(
            params, cfg, key, batch=ZOO_GEN_BATCH, n_steps=ZOO_GEN_STEPS,
            txt_emb=txt, latent_res=r)

    x, c = counted(sample)
    expect_launches(c, {}, "rf_sample")
    step_ms = once_ms(sample) / ZOO_GEN_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = count_params(params)
    if x.shape != (ZOO_GEN_BATCH, r, r, cfg.latent_channels) or not bool(
            torch.isfinite(x).all()):
        raise AssertionError("rf_sample latents not finite or of the "
                             "wrong shape")
    print(f"zoo flux-dev ({n_params / 1e9:.3f}B parameters, "
          f"{cfg.n_double_blocks} double + {cfg.n_single_blocks} single "
          f"blocks, init {init_s:.1f} s): rf_sample gen_fast "
          f"[{ZOO_GEN_BATCH}, latent {r}, {(r // cfg.patch) ** 2} image + "
          f"{mmdit_module.TXT_TOKENS} text tokens, {ZOO_GEN_STEPS} steps] "
          f"{step_ms:.2f} ms a step, |x| max {float(x.abs().max()):.3e}, "
          f"peak {peak:.2f} GiB; no kernel", flush=True)
    if peak > ZOO_PEAK_GIB:
        raise AssertionError(f"flux-dev peak {peak:.1f} GiB > {ZOO_PEAK_GIB}:"
                             f" cut its depth")
    return {"params": n_params, "step_ms": step_ms, "peak_gib": peak,
            "init_s": init_s}


def _card_vs_cpu(dev, label, fn, args, dtype, worst) -> None:
    """fn(*args) on the CPU and on the card (args moved), max |card - CPU|
    over max(1, max |CPU|) within ZOO_CPU_TOL; recorded in `worst`."""
    dev_args = tree_map(lambda t: t.to(dev), list(args))
    want = fn(*args)
    got = fn(*dev_args)
    want, got = (want if isinstance(want, tuple) else (want,),
                 got if isinstance(got, tuple) else (got,))
    err = max(float((g.cpu().float() - w.float()).abs().max())
              / max(1.0, float(w.float().abs().max()))
              for g, w in zip(got, want))
    worst[label] = err
    if err > ZOO_CPU_TOL[dtype] or not all(bool(torch.isfinite(g).all())
                                           for g in got):
        raise AssertionError(f"zoo {label}: card vs CPU {err:.3e} > "
                             f"{ZOO_CPU_TOL[dtype]}")


def zoo_block_parity(dev) -> dict:
    """One block of each family at full width, float32, batch 1, on the
    card and on the CPU, weights drawn by numpy: a Swin stage-3 block (14
    x 14 map, dim 512, 16 heads, window 7, shifted by 3), a DiT-L/2 block
    and a Flux double and single block (ZOO_BLOCK_TOKENS image tokens,
    128 text tokens)."""
    f32 = torch.float32
    rng = np.random.default_rng(ZOO_SEED)
    worst = {}

    def weights(tree):
        return params_from_numpy(perturb_numpy(tree, rng), f32, "cpu")

    def normal(*shape):
        return torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32))

    with torch.no_grad(), full_float32():
        w = 7
        bp = weights(swin_module.swin_block_init(rng, 512, 16, w,
                                                 device="cpu"))
        idx = torch.as_tensor(swin_module._rel_position_index(w))
        _card_vs_cpu(dev, "swin-b stage-3 block", lambda p, x, i: (
            swin_module.swin_block(p, x, n_heads=16, window=w, shift=w // 2,
                                   rel_index=i)),
            (bp, normal(1, 14, 14, 512), idx), f32, worst)
        cfg = dataclasses.replace(get_config("dit-l2"), dtype=f32)
        bp = weights(dit_module.dit_block_init(rng, cfg, device="cpu"))
        _card_vs_cpu(dev, "dit-l2 block", lambda p, x, c: dit_module.dit_block(
            p, x, c, cfg), (bp, normal(1, ZOO_BLOCK_TOKENS, cfg.d_model),
                            normal(1, cfg.d_model)), f32, worst)
        cfg = dataclasses.replace(get_config("flux-dev"), dtype=f32)
        d, tt = cfg.d_model, mmdit_module.TXT_TOKENS
        bp = weights(mmdit_module.double_block_init(rng, cfg, device="cpu"))
        _card_vs_cpu(dev, "flux-dev double block",
                     lambda p, i, t, c: mmdit_module.double_block(p, i, t, c,
                                                                  cfg),
                     (bp, normal(1, ZOO_BLOCK_TOKENS, d), normal(1, tt, d),
                      normal(1, d)), f32, worst)
        del bp
        bp = weights(mmdit_module.single_block_init(rng, cfg, device="cpu"))
        _card_vs_cpu(dev, "flux-dev single block",
                     lambda p, x, c: mmdit_module.single_block(p, x, c, cfg),
                     (bp, normal(1, ZOO_BLOCK_TOKENS + tt, d), normal(1, d)),
                     f32, worst)
    print("zoo full-width blocks, float32, card vs CPU (max abs err over "
          "max(1, |CPU|)): " + ", ".join(f"{k} {v:.2e}"
                                         for k, v in worst.items())
          + f" (tol {ZOO_CPU_TOL[f32]})", flush=True)
    return worst


def zoo_small_parity(dev) -> dict:
    """The six SMOKE configs in float32 and bf16 on the card and on the
    CPU, weights and inputs drawn by numpy (tests/torch_zoo_weights.py):
    forwards, losses and samplers within ZOO_CPU_TOL; the ViTs' forward
    with impl="flash" (the kernel on the card, its plain version on the
    CPU) launches flash_attention once per layer."""
    worst = {}
    with torch.no_grad(), exact_bf16():
        for arch in ("vit-s16", "vit-b16", "vit-h14", "swin-b", "dit-l2",
                     "flux-dev"):
            for dtype in (torch.float32, torch.bfloat16):
                cfg = dataclasses.replace(get_smoke_config(arch),
                                          dtype=dtype)
                tree = numpy_weights(cfg)
                want = smoke_outputs(cfg, params_from_numpy(tree, dtype,
                                                            "cpu"), "cpu")
                got, c = counted(lambda: smoke_outputs(
                    cfg, params_from_numpy(tree, dtype, dev), dev,
                    vit_impl="flash"))
                vit = cfg.family == "vision" and not cfg.swin
                expect_launches(c, {"flash_attention": cfg.n_layers}
                                if vit else {}, f"{arch} smoke")
                err = max(float((g.cpu().float() - w.float()).abs().max())
                          / max(1.0, float(w.float().abs().max()))
                          for g, w in zip(got, want))
                worst[f"{arch} {str(dtype)[6:]}"] = err
                if err > ZOO_CPU_TOL[dtype]:
                    raise AssertionError(f"zoo {arch} {dtype} smoke: card "
                                         f"vs CPU {err:.3e}")
    print("zoo small input, card vs CPU (forward, loss, sampler at 2 "
          "steps; max abs err over max(1, |CPU|)): " + ", ".join(
              f"{k} {v:.2e}" for k, v in worst.items()), flush=True)
    return worst


def zoo_phase(dev) -> dict:
    """Phase 8e. Returns the flash_attention launches by ViT path, the
    two ViT flash rows and each model's numbers."""
    t0 = time.perf_counter()
    out = {"launches": {}}
    with torch.no_grad():
        for arch in ZOO_VITS:
            out[arch] = zoo_vit(dev, arch)
            out["launches"].update(out[arch].pop("launches"))
            torch.cuda.empty_cache()
        out["rows"] = {
            "[128, 257, 16, 80] bf16 (ViT-H/14)": flash_case(
                dev, ZOO_SERVE_BATCH, 257, 257, 16, 16, 80,
                dtype=torch.bfloat16, library=True),
            "[128, 197, 12, 64] bf16 (ViT-B/16)": flash_case(
                dev, ZOO_SERVE_BATCH, 197, 197, 12, 12, 64,
                dtype=torch.bfloat16, library=True)}
        torch.cuda.empty_cache()
        out["swin-b"] = zoo_swin(dev)
        torch.cuda.empty_cache()
        out["dit-l2"] = zoo_dit(dev)
        torch.cuda.empty_cache()
        out["flux-dev"] = zoo_flux(dev)
        torch.cuda.empty_cache()
    out["blocks"] = zoo_block_parity(dev)
    out["small"] = zoo_small_parity(dev)
    out["seconds"] = time.perf_counter() - t0
    print(f"zoo phase: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8f: the training substrate (PR 22)
# ---------------------------------------------------------------------------

def _train_counted(launches: dict, label: str, fn):
    """counted(fn) with no kernel allowed; the counts are added to
    launches[label]."""
    out, c = counted(fn)
    total = launches.setdefault(label, {})
    for k, v in c.items():
        total[k] = total.get(k, 0) + v
    expect_launches(c, {}, label)
    return out


def _train_steps(ts, params, opt, batches, key, label: str,
                 launches: dict):
    """ts.step over `batches` (step i's key fold_in(key, 10**6 + i), as
    the launcher's), each counted from 0: no kernel may launch, loss and
    grad_norm must be finite and AdamW's moments float32 after every
    step. Returns (params, opt, [(loss, grad_norm)], [ms a step], host
    clock around each synchronised step)."""
    metrics, ms = [], []
    for i, batch in enumerate(batches):
        k = prng.fold_in(key, 10 ** 6 + i)
        t0 = time.perf_counter()
        params, opt, m = _train_counted(
            launches, label, lambda: ts.step(params, opt, batch, k))
        ms.append((time.perf_counter() - t0) * 1e3)
        lg = (float(m["loss"]), float(m["grad_norm"]))
        if not all(math.isfinite(v) for v in lg):
            raise AssertionError(f"{label} step {i + 1}: loss, grad_norm "
                                 f"{lg}")
        metrics.append(lg)
        if isinstance(opt, trainer_module.optim.AdamState):
            dts = {t.dtype for t in tree_leaves(opt.mu) + tree_leaves(
                opt.nu)}
            if dts != {torch.float32}:
                raise AssertionError(f"{label} step {i + 1}: moments "
                                     f"{dts}, want float32")
    return params, opt, metrics, ms


def _moved(before, params, label: str) -> float:
    """Every leaf moved somewhere in its first 4096 elements, but those
    whose sampled values are all of magnitude >= 0.5 (norm scales at
    1.0: in bf16 their spacing 2^-7 is 78 lr, so an lr-sized update
    rounds away); returns the share of all sampled elements that
    moved."""
    moved = total = 0
    for b, p in zip(before, tree_leaves(params)):
        d = p.reshape(-1)[:b.numel()] != b
        if bool((b.float().abs() < 0.5).any()) and not bool(d.any()):
            raise AssertionError(f"{label}: a {tuple(p.shape)} parameter "
                                 "did not move")
        moved += int(d.sum())
        total += d.numel()
    return moved / total


def train_lm_full(dev, launches: dict) -> dict:
    """stablelm-3b at full width and depth, bf16, remat, AdamW (donated
    state), global batch TRAIN_LM_BATCH x TRAIN_LM_SEQ in TRAIN_LM_MICRO
    microbatches, TRAIN_STEPS steps on the launcher's synthetic token
    streams."""
    cfg = get_config(TRAIN_LM_ARCH)
    if not cfg.remat or cfg.dtype != torch.bfloat16:
        raise AssertionError("stablelm-3b trains in bf16 with remat")
    # donated, as the launcher's loop does: a functional update holds the
    # old and the new state together (PERF.md, PR 22)
    ts = trainer_module.make_train_step(cfg, optimizer="adamw",
                                        microbatches=TRAIN_LM_MICRO,
                                        donate=True)
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    params = ts.init_params(gen, dev)
    opt = ts.init_opt(params)
    n_params = sum(p.numel() for p in tree_leaves(params))
    shape = ShapeSpec("train_4k, cut", "train", seq_len=TRAIN_LM_SEQ,
                      global_batch=TRAIN_LM_BATCH)
    key = prng.PRNGKey(TRAIN_SEED, device=dev)
    batches = [{k: v.reshape((TRAIN_LM_MICRO, -1) + v.shape[1:])
                for k, v in synthetic_batch(cfg, shape, prng.fold_in(
                    key, i)).items()} for i in range(TRAIN_STEPS)]
    before = [p.reshape(-1)[:4096].clone() for p in tree_leaves(params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt, metrics, ms = _train_steps(ts, params, opt, batches, key,
                                            "stablelm-3b steps", launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = _moved(before, params, "train stablelm-3b")
    step_ms = sum(ms[1:]) / len(ms[1:])
    tokens = TRAIN_LM_BATCH * TRAIN_LM_SEQ
    # where a step's time goes: one microbatch's loss and gradients
    # (forward, recompute, backward), and the donated AdamW update on
    # them (host clock around synchronised calls)
    mb0 = {k: v[0] for k, v in batches[0].items()}
    loss_fn = trainer_module._loss_for(cfg)
    t0 = time.perf_counter()
    _, grads = _train_counted(
        launches, "stablelm-3b steps", lambda: trainer_module.value_and_grad(
            loss_fn, params, mb0, key))
    grad_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _train_counted(launches, "stablelm-3b steps",
                   lambda: trainer_module.optim.adamw_update(
                       params, grads, opt, lr=1e-4, weight_decay=0.01,
                       donate=True))
    update_ms = (time.perf_counter() - t0) * 1e3
    del grads
    row = {"params": n_params, "loss": [m[0] for m in metrics],
           "grad_norm": [m[1] for m in metrics], "ms": ms,
           "step_ms": step_ms, "tokens_per_s": tokens * 1e3 / step_ms,
           "peak_gib": peak, "moved_share": moved,
           "microbatch_grad_ms": grad_ms, "update_ms": update_ms}
    print(f"train stablelm-3b bf16, remat, AdamW donated "
          f"({n_params / 1e9:.4f}B "
          f"parameters): {TRAIN_STEPS} steps at {TRAIN_LM_BATCH} x "
          f"{TRAIN_LM_SEQ} tokens in {TRAIN_LM_MICRO} microbatches; loss "
          + " -> ".join(f"{m[0]:.4f}" for m in metrics) + ", grad_norm "
          + " -> ".join(f"{m[1]:.3f}" for m in metrics)
          + f"; ms a step " + " / ".join(f"{t:.1f}" for t in ms)
          + f" ({step_ms:.1f} over steps 2-{TRAIN_STEPS}: "
          f"{row['tokens_per_s']:.0f} tokens/s); peak {peak:.2f} GiB; "
          f"moments float32 after step 1; {moved:.1%} of sampled "
          "parameters moved (every leaf but the norm scales); one "
          f"microbatch's gradients {grad_ms:.1f} ms, the update "
          f"{update_ms:.1f} ms; 0 kernel launches",
          flush=True)
    return row


def train_lm_checks(dev, launches: dict) -> dict:
    """stablelm-3b at full width, depth cut to TRAIN_CHECK_LAYERS, in
    float32, batch TRAIN_CHECK_BATCH x TRAIN_LM_SEQ: gradients with remat
    on and off (TRAIN_REMAT_REL), and one AdamW step with 4 microbatches
    against 1 (check_step's float32 tolerances: the sums run in another
    order)."""
    cfg = dataclasses.replace(get_config(TRAIN_LM_ARCH),
                              n_layers=TRAIN_CHECK_LAYERS,
                              dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 1)
    params = trainer_module.make_train_step(cfg).init_params(gen, dev)
    key = prng.PRNGKey(TRAIN_SEED + 1, device=dev)
    batch = synthetic_batch(cfg, ShapeSpec(
        "check", "train", seq_len=TRAIN_LM_SEQ,
        global_batch=TRAIN_CHECK_BATCH), key)
    grads = {}
    for flag in (True, False):
        loss_fn = trainer_module._loss_for(dataclasses.replace(
            cfg, remat=flag))
        loss, g = _train_counted(
            launches, "stablelm-3b depth-2 checks",
            lambda: trainer_module.value_and_grad(loss_fn, params, batch,
                                                  key))
        grads[flag] = (float(loss), g)
        del g
    remat_err = max(float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(tree_leaves(grads[True][1]),
                                    tree_leaves(grads[False][1])))
    if grads[True][0] != grads[False][0] or remat_err > TRAIN_REMAT_REL:
        raise AssertionError(f"train check: remat on vs off: loss "
                             f"{grads[True][0]} vs {grads[False][0]}, "
                             f"gradients {remat_err:.3e}")
    del grads
    steps = {}
    for m in (1, TRAIN_LM_MICRO):
        ts = trainer_module.make_train_step(cfg, microbatches=m)
        b = batch if m == 1 else {k: v.reshape((m, -1) + v.shape[1:])
                                  for k, v in batch.items()}
        steps[m] = _train_counted(
            launches, "stablelm-3b depth-2 checks",
            lambda: ts.step(params, ts.init_opt(params), b, key))
    micro = check_step(steps[TRAIN_LM_MICRO], steps[1], torch.float32,
                       f"train check: {TRAIN_LM_MICRO} microbatches vs 1")
    print(f"train stablelm-3b float32, depth cut to {TRAIN_CHECK_LAYERS}, "
          f"{TRAIN_CHECK_BATCH} x {TRAIN_LM_SEQ}: remat on vs off loss "
          f"equal, gradients {remat_err:.3e} of each leaf's largest (tol "
          f"{TRAIN_REMAT_REL}); {TRAIN_LM_MICRO} microbatches vs 1: "
          + ", ".join(f"{k} {v:.3e}" for k, v in micro.items()),
          flush=True)
    return {"remat_rel": remat_err, "microbatches": micro}


def train_vit_full(dev, launches: dict) -> dict:
    """ViT-B/16 at full width and depth, bf16, Adafactor, batch
    TRAIN_VIT_BATCH at 224 px, TRAIN_STEPS steps on the launcher's
    synthetic images."""
    cfg = get_config(TRAIN_VIT_ARCH)
    ts = trainer_module.make_train_step(cfg, optimizer="adafactor")
    gen = torch.Generator(device=dev).manual_seed(TRAIN_SEED + 2)
    params = ts.init_params(gen, dev)
    opt = ts.init_opt(params)
    shape = ShapeSpec("cls_224", "train", img_res=cfg.img_res,
                      global_batch=TRAIN_VIT_BATCH)
    key = prng.PRNGKey(TRAIN_SEED + 2, device=dev)
    batches = [synthetic_batch(cfg, shape, prng.fold_in(key, i))
               for i in range(TRAIN_STEPS)]
    before = [p.reshape(-1)[:4096].clone() for p in tree_leaves(params)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt, metrics, ms = _train_steps(ts, params, opt, batches, key,
                                            "vit-b16 steps", launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = _moved(before, params, "train vit-b16")
    step_ms = sum(ms[1:]) / len(ms[1:])
    row = {"loss": [m[0] for m in metrics], "ms": ms, "step_ms": step_ms,
           "images_per_s": TRAIN_VIT_BATCH * 1e3 / step_ms,
           "peak_gib": peak, "moved_share": moved}
    print(f"train vit-b16 bf16, Adafactor: {TRAIN_STEPS} steps at batch "
          f"{TRAIN_VIT_BATCH}, {cfg.img_res} px; loss "
          + " -> ".join(f"{m[0]:.4f}" for m in metrics) + "; ms a step "
          + " / ".join(f"{t:.1f}" for t in ms)
          + f" ({step_ms:.1f} over steps 2-{TRAIN_STEPS}: "
          f"{row['images_per_s']:.0f} images/s); peak {peak:.2f} GiB; "
          f"{moved:.1%} of sampled parameters moved; 0 kernel launches",
          flush=True)
    return row


def _file_bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def train_launcher_phase(dev) -> dict:
    """`python -m repro_torch.launch.train --arch vit-b16 --steps 6
    --batch 8 --ckpt-dir D` as a subprocess on the card, then again with
    --steps 10: the second prints "restored checkpoint step 6" and ends
    at step 10. Step 6's checkpoint restores in this process (the
    manifest's paths those of tree_paths, which the CPU tests hold equal
    to the reference's keystr; parameters bf16, the step int32, the
    moments float32) and, saved again, gives the same manifest and shard
    bytes: the restored tree is the saved one bit for bit."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    first, last = TRAIN_LAUNCH_STEPS
    ckpt_dir = tempfile.mkdtemp(prefix="train_launch_")
    again_dir = tempfile.mkdtemp(prefix="train_resave_")
    out = {}
    try:
        for steps in TRAIN_LAUNCH_STEPS:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 TRAIN_VIT_ARCH, "--steps", str(steps), "--batch", "8",
                 "--ckpt-dir", ckpt_dir], env=env, cwd=root,
                capture_output=True, text=True, timeout=600)
            out[steps] = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(
                    f"launch.train --steps {steps}: exit {proc.returncode}"
                    f"\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith(("step", "restored"))]
            print(f"train launcher --steps {steps} ({out[steps]:.1f} s): "
                  + "; ".join(lines), flush=True)
            if steps == first:
                step_dir = os.path.join(ckpt_dir, f"step_{first:08d}")
                cfg = get_config(TRAIN_VIT_ARCH)
                ts = trainer_module.make_train_step(cfg)
                like = ts.init_params(torch.Generator(device=dev), dev)
                like = (like, ts.init_opt(like))
                tree, manifest = ckpt_module.restore(ckpt_dir, first, like)
                paths = ckpt_module.tree_paths(like)
                want = {p: ("int32" if p == "[1].step" else "bfloat16"
                            if p.startswith("[0]") else "float32")
                        for p in paths}
                got = {p: m["dtype"] for p, m in manifest["meta"].items()}
                if manifest["paths"] != paths or got != want:
                    raise AssertionError("launch.train checkpoint: paths or "
                                         "dtypes off the pinned ones")
                if int(tree[1].step) != first or manifest["step"] != first:
                    raise AssertionError("launch.train checkpoint: step "
                                         f"{int(tree[1].step)}")
                again = ckpt_module.save(again_dir, first, tree)
                for name in ("manifest.json", "shard_00000.msgpack"):
                    if _file_bytes(os.path.join(again, name)) != \
                            _file_bytes(os.path.join(step_dir, name)):
                        raise AssertionError(f"launch.train checkpoint: "
                                             f"{name} differs once restored "
                                             "and saved again")
                out["checkpoint_mb"] = os.path.getsize(os.path.join(
                    step_dir, "shard_00000.msgpack")) / 1e6
                del tree, like
            elif f"restored checkpoint step {first}" not in proc.stdout:
                raise AssertionError("launch.train did not resume from "
                                     f"step {first}")
        if ckpt_module.latest_step(ckpt_dir) != last:
            raise AssertionError("launch.train: no checkpoint at step "
                                 f"{last}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        shutil.rmtree(again_dir, ignore_errors=True)
    print(f"train launcher: step {first} checkpoint "
          f"({out['checkpoint_mb']:.1f} MB) restored bit for bit, paths "
          "and dtypes as pinned; resumed to step " f"{last}", flush=True)
    return out


def train_small_parity(dev, launches: dict) -> dict:
    """One AdamW train step of each SMOKE config in float32 and bf16 (the
    detector float32 only) on the card and on the CPU, weights and
    batches drawn by numpy (tests/torch_train_inputs.py): check_step's
    tolerances, no kernel launched."""
    worst = {}
    with exact_bf16():
        for arch in TRAIN_ARCHS:
            for dtype in (torch.float32, torch.bfloat16):
                cfg = train_smoke(arch, dtype)
                if getattr(cfg, "dtype", torch.float32) != dtype:
                    continue
                label = f"{arch} {str(dtype)[6:]}"
                ts = trainer_module.make_train_step(cfg)
                params = train_params(cfg)
                batch = numpy_batch(cfg)
                want = ts.step(params, ts.init_opt(params),
                               torch_batch(batch), prng.PRNGKey(3))
                pd = tree_map(lambda t: t.to(dev), params)
                got = _train_counted(launches, "smoke steps", lambda: ts.step(
                    pd, ts.init_opt(pd), torch_batch(batch, dev),
                    prng.PRNGKey(3, device=dev)))
                worst[label] = check_step(got, want, dtype,
                                          f"train {label} smoke, card vs "
                                          "CPU")
    print("train small input, one step card vs CPU (loss and grad_norm "
          "relative, params absolute): " + "; ".join(
              f"{k} {v['loss']:.1e} {v['grad_norm']:.1e} {v['params']:.1e}"
              for k, v in worst.items()), flush=True)
    return worst


def train_phase(dev) -> dict:
    """Phase 8f. Returns each path's numbers and its kernel launches
    (none may launch one)."""
    t0 = time.perf_counter()
    launches = {}
    out = {"launches": launches,
           "stablelm-3b": train_lm_full(dev, launches)}
    torch.cuda.empty_cache()
    out["stablelm-3b checks"] = train_lm_checks(dev, launches)
    torch.cuda.empty_cache()
    out["vit-b16"] = train_vit_full(dev, launches)
    torch.cuda.empty_cache()
    out["launcher"] = train_launcher_phase(dev)
    out["small"] = train_small_parity(dev, launches)
    out["seconds"] = time.perf_counter() - t0
    print(f"train phase: {out['seconds']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8g: sharding (PR 23)
# ---------------------------------------------------------------------------

SHARD_MICRO, SHARD_SEQ = 4, 2048     # pipeline: 4 microbatches [1, 2048]
# ring_reduce_attend at stablelm-3b's decode shape: 4 requests, a cache of
# 2048 prompt + 16 decoded positions, 32 heads of 80
SHARD_DECODE = (4, LM_PROMPT + LM_CONT, 32, 80)
# float32 ring vs the plain full attention: the same float32 products, the
# softmax's sums over 2064 keys in another order, on outputs of order 1
SHARD_ATTEND_ATOL = 1e-5
# the two-process fleet's pred_acc: each rank's detector forward runs over
# half the crops, where cuBLAS may take another algorithm (float32, TF32
# off: sums in another order, round-off of scores in [0, 1])
SHARD_PRED_ATOL = 1e-5
SHARD_PROCS = 2


def _shard_rank(rank, spec) -> dict:
    """One process of phase 8g.2, a rank of tests/torch_dist.py's gloo
    group (NCCL refuses two ranks on one device): half the fleet of
    `spec` on cuda:0."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res, counts = counted(lambda: run_fleet(dataclasses.replace(
        spec, shard=ShardSpec("debug", n_data=SHARD_PROCS))))
    return {"chosen": res.chosen, "frames_sent": res.frames_sent,
            "accuracy": res.accuracy, "acc_per_step": res.acc_per_step,
            "pred_acc": res.out.pred_acc.cpu().numpy(),
            "steady_s": res.timings["steady_s"],
            "compile_s": res.timings["compile_s"], "launches": counts}


def _fleet_summary(result) -> dict:
    return {"chosen": result.chosen, "frames_sent": result.frames_sent,
            "accuracy": result.accuracy,
            "acc_per_step": result.acc_per_step,
            "pred_acc": result.out.pred_acc.cpu().numpy(),
            "steady_s": result.timings["steady_s"]}


def shard_fleet_one_rank(spec: FleetRunSpec, whole: dict) -> dict:
    """8g.1: the main path's cell with ShardSpec("debug"): a 1 x 1 NCCL
    mesh. Bit-equal to phase 5's unsharded run."""
    res, counts = counted(lambda: run_fleet(dataclasses.replace(
        spec, shard={"kind": "debug"})))
    expect_launches(counts, {k: N_STEPS + 1 for k in MAIN_PATH_KERNELS},
                    "sharded fleet, one rank")
    got = _fleet_summary(res)
    for k in ("chosen", "frames_sent", "accuracy", "acc_per_step"):
        if got[k] != whole[k]:
            raise AssertionError(f"sharded fleet, one rank: {k} differs "
                                 f"from the unsharded run")
    if not np.array_equal(got["pred_acc"], whole["pred_acc"]):
        raise AssertionError("sharded fleet, one rank: pred_acc differs")
    print(f"shard fleet, 1 rank (NCCL 1 x 1): accuracy={res.accuracy:.6f} "
          f"(bit-equal to the unsharded run) steady_s="
          f"{got['steady_s']:.3f} (unsharded {whole['steady_s']:.3f}) "
          f"launches={counts}", flush=True)
    return {"steady_s": got["steady_s"], "launches": counts}


def shard_fleet_two_procs(spec: FleetRunSpec, whole: dict) -> dict:
    """8g.2: the same fleet split over two processes sharing the card, a
    gloo group over a file store (tests/torch_dist.spawn: spawned, as
    this process has CUDA up). Decisions equal to the unsharded run's;
    pred_acc within SHARD_PRED_ATOL."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        got = torch_dist.spawn(_shard_rank, SHARD_PROCS, tmp, spec).join()
    wall = time.perf_counter() - t0
    out = {"wall_s": wall}
    for rank, r in enumerate(got):
        expect_launches(r["launches"],
                        {k: N_STEPS + 1 for k in MAIN_PATH_KERNELS},
                        f"sharded fleet, {SHARD_PROCS} processes, rank "
                        f"{rank}")
        if r["chosen"] != whole["chosen"] or \
                r["frames_sent"] != whole["frames_sent"]:
            raise AssertionError(f"{SHARD_PROCS} processes, rank {rank}: "
                                 f"decisions differ from the unsharded run")
        pred_err = float(np.abs(r["pred_acc"] - whole["pred_acc"]).max())
        acc_err = abs(r["accuracy"] - whole["accuracy"])
        if pred_err > SHARD_PRED_ATOL or acc_err > SHARD_PRED_ATOL:
            raise AssertionError(f"{SHARD_PROCS} processes, rank {rank}: "
                                 f"pred_acc {pred_err}, accuracy {acc_err}")
        out[f"rank {rank}"] = {"steady_s": r["steady_s"],
                               "compile_s": r["compile_s"],
                               "pred_acc_err": pred_err,
                               "accuracy_err": acc_err,
                               "launches": r["launches"]}
        print(f"shard fleet, {SHARD_PROCS} processes (gloo, "
              f"{N_CAMERAS // SHARD_PROCS} cameras each on cuda:0), rank "
              f"{rank}: decisions equal, "
              f"accuracy={r['accuracy']:.6f} (err {acc_err:.2e}), pred_acc "
              f"max err {pred_err:.2e}, steady_s={r['steady_s']:.3f} "
              f"compile_s={r['compile_s']:.3f} launches={r['launches']}",
              flush=True)
    print(f"shard fleet, {SHARD_PROCS} processes: {wall:.1f} s with the "
          f"processes' start", flush=True)
    return out


def shard_pipeline(dev, cfg, params, mesh) -> dict:
    """8g.3: stablelm-3b's 32 layers (bf16, flash) through
    make_pipelined_forward on the one-rank mesh, S = 1, M microbatches
    of [1, SHARD_SEQ]; each output bit-equal to the layers run in
    sequence on it; flash once per layer and microbatch."""
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 23)
    toks = torch.randint(0, cfg.vocab, (SHARD_MICRO, 1, SHARD_SEQ),
                         generator=gen, device=dev)
    angles = attention_module.rope_frequencies(
        cfg.resolved_head_dim, SHARD_SEQ, cfg.rope_theta, device=dev)

    def body(lp, x, extra):
        return dense_block(lp, x, cfg, extra, "flash")

    fn = make_pipelined_forward(body, mesh, 1)
    staged = split_stages(params["layers"], 1)
    with torch.no_grad():
        x = layers_module.embedding(params["embed"], toks)  # [M, 1, S, D]
        piped, counts = counted(lambda: fn(staged, x, angles))

        def sequential():
            outs = []
            for h in x:
                for i in range(cfg.n_layers):
                    h = body(layer_params(params["layers"], i), h, angles)
                outs.append(h)
            return torch.stack(outs)

        seq = sequential()
        expect_launches(counts, {"flash_attention": SHARD_MICRO
                                 * cfg.n_layers}, "pipeline")
        if not torch.equal(piped, seq):
            raise AssertionError(f"pipeline: outputs differ from the "
                                 f"sequential layers by "
                                 f"{float((piped - seq).abs().max())}")
        if not bool(torch.isfinite(piped).all()):
            raise AssertionError("pipeline: non-finite outputs")
        pipe_ms = cuda_ms(lambda: fn(staged, x, angles), 2) / SHARD_MICRO
        seq_ms = cuda_ms(sequential, 2) / SHARD_MICRO
    print(f"shard pipeline: stablelm-3b bf16, {cfg.n_layers} layers, S = 1, "
          f"{SHARD_MICRO} microbatches of [1, {SHARD_SEQ}]: bit-equal to the "
          f"layers in sequence; {pipe_ms:.2f} ms a microbatch (sequential "
          f"{seq_ms:.2f}); launches={counts}", flush=True)
    return {"ms_per_microbatch": pipe_ms, "sequential_ms": seq_ms,
            "launches": counts}


def shard_collectives(dev, mesh) -> dict:
    """8g.4: ring_reduce_attend at stablelm-3b's decode shape against the
    plain full attention (float32 within SHARD_ATTEND_ATOL; bf16 within
    one bf16 ulp of the outputs' magnitude), psum_scatter_grads and
    ring_allgather as identities on the one-rank NCCL group."""
    b, s, h, d = SHARD_DECODE
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 24)
    q = torch.randn((b, 1, h, d), generator=gen, device=dev)
    k = torch.randn((b, s, h, d), generator=gen, device=dev)
    v = torch.randn((b, s, h, d), generator=gen, device=dev)
    scale = 1.0 / math.sqrt(d)
    grp = (mesh, "model")
    grads = {"w": torch.randn((4096, 2560), generator=gen, device=dev),
             "b": torch.randn((2560,), generator=gen, device=dev)}
    x = torch.randn((8, 80), generator=gen, device=dev)
    inputs = {name: (q.to(dt), k.to(dt), v.to(dt)) for name, dt in
              (("float32", torch.float32), ("bf16", torch.bfloat16))}

    def run():
        return ({name: ring_reduce_attend(*a, grp, scale=scale)
                 for name, a in inputs.items()},
                psum_scatter_grads(grads, (mesh, "data")),
                ring_allgather(x, grp))

    (attended, scattered, gathered), launches = counted(run)
    if launches:
        raise AssertionError(f"collectives launched kernels: {launches}")
    out = {}
    for name, (qd, kd, vd) in inputs.items():
        got = attended[name]
        w = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qd.float(),
                                       kd.float()) * scale, -1)
        want = torch.einsum("bhqk,bkhd->bqhd", w, vd.float())
        err = float((got.float() - want).abs().max())
        if name == "float32":
            tol = SHARD_ATTEND_ATOL
        else:
            tol = 2.0 ** (math.floor(math.log2(float(want.abs().max())))
                          - 7)
        if err > tol or got.dtype != qd.dtype:
            raise AssertionError(f"ring_reduce_attend {name}: max err "
                                 f"{err} > {tol}")
        ms = cuda_ms(lambda: ring_reduce_attend(qd, kd, vd, grp,
                                                scale=scale), 5)
        out[name] = {"max_abs_err": err, "tol": tol, "ms": ms}
    if not (all(torch.equal(scattered[n], grads[n]) for n in grads)
            and torch.equal(gathered, x[None])):
        raise AssertionError("psum_scatter_grads / ring_allgather are not "
                             "identities at one rank")
    print(f"shard collectives (NCCL, 1 rank): ring_reduce_attend q [{b}, 1, "
          f"{h}, {d}], cache [{b}, {s}, {h}, {d}]: float32 max err "
          f"{out['float32']['max_abs_err']:.2e} (tol {SHARD_ATTEND_ATOL}), "
          f"{out['float32']['ms']:.3f} ms; bf16 max err "
          f"{out['bf16']['max_abs_err']:.2e} (tol {out['bf16']['tol']}), "
          f"{out['bf16']['ms']:.3f} ms; psum_scatter_grads and "
          f"ring_allgather identities", flush=True)
    return {"attend": out, "launches": launches}


def shard_elastic(dev, params, mesh) -> dict:
    """8g.5a: stablelm-3b's bf16 parameters laid out by param_shardings
    on the one-rank mesh (DTensors), saved, restored and laid out again:
    bit-equal. Bytes and seconds of each step."""
    shardings = param_shardings(params, mesh)
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        def run():
            laid = timed("reshard_s", lambda: reshard(params, shardings))
            timed("save_s", lambda: ckpt_module.save(tmp, 1, laid))
            del laid
            restored = timed("restore_s", lambda: ckpt_module.restore(
                tmp, 1, params)[0])
            return timed("reshard_again_s",
                         lambda: reshard(restored, shardings))

        back, launches = counted(run)
        n_bytes = sum(f.stat().st_size
                      for f in Path(tmp).rglob("*") if f.is_file())
    flat_p = tree_leaves(params)
    flat_b = tree_leaves(back)
    if len(flat_p) != len(flat_b) or not all(
            torch.equal(b.full_tensor(), p) for p, b in zip(flat_p, flat_b)):
        raise AssertionError("elastic: the restored, resharded parameters "
                             "differ from the saved ones")
    if launches:
        raise AssertionError(f"elastic launched kernels: {launches}")
    print(f"shard elastic: stablelm-3b bf16 ({len(flat_p)} leaves) reshard "
          f"{times['reshard_s']:.2f} s, save {times['save_s']:.2f} s "
          f"({n_bytes / 1e9:.3f} GB), restore {times['restore_s']:.2f} s, "
          f"reshard {times['reshard_again_s']:.2f} s: bit-equal", flush=True)
    return {"bytes": n_bytes, **times, "launches": launches}


def shard_compression(dev, mesh) -> dict:
    """8g.5b: crosspod_allreduce_compressed over ViT-B/16's float32
    gradient tree (batch 8) on the one-rank mesh: the mean is the
    dequantized gradient; each leaf within half a quantization step of
    the exact gradient."""
    cfg = dataclasses.replace(get_config("vit-b16"), dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(LM_SEED + 25)
    params = vit_module.vit_init(gen, cfg, device=dev)
    images = torch.rand((8, cfg.img_res, cfg.img_res, 3), generator=gen,
                        device=dev)
    labels = torch.randint(0, cfg.n_classes, (8,), generator=gen,
                           device=dev)
    _, grads = trainer_module.value_and_grad(
        lambda p: vit_module.vit_loss(p, cfg, images, labels), params)
    state = compression_module.init_ef(grads)
    (mean, state), launches = counted(
        lambda: compression_module.crosspod_allreduce_compressed(
            grads, state, group=(mesh, "data")))
    errs, worst = [], 0.0
    for g, m in zip(tree_leaves(grads), tree_leaves(mean)):
        if not torch.equal(m, compression_module.dequantize_int8(
                *compression_module.quantize_int8(g))):
            raise AssertionError("compression: the one-rank mean is not "
                                 "the dequantized gradient")
        step = max(float(g.abs().max()), 1e-12) / 127.0
        err = float((m - g).abs().max())
        errs.append(err)
        worst = max(worst, err / step)
    # round to nearest: half a step, plus the float32 rounding of the
    # scaled value and of the product back
    if worst > 0.5 + 1e-3 or launches:
        raise AssertionError(f"compression: error {worst} quantization "
                             f"steps, launches {launches}")
    n = sum(g.numel() for g in tree_leaves(grads))
    print(f"shard compression: ViT-B/16 float32 gradients ({n:,} elements, "
          f"{len(errs)} leaves), one rank: max abs err {max(errs):.3e} "
          f"against the exact gradient, at most {worst:.3f} of a leaf's "
          f"quantization step (bound 0.5)", flush=True)
    return {"max_abs_err": max(errs), "max_steps": worst,
            "launches": launches}


def shard_phase(dev, spec: FleetRunSpec, whole: dict) -> dict:
    """Phase 8g. Returns each path's numbers and kernel launches."""
    t0 = time.perf_counter()
    out = {"fleet 1 rank": shard_fleet_one_rank(spec, whole)}
    mesh = make_debug_mesh()
    out[f"fleet {SHARD_PROCS} processes"] = shard_fleet_two_procs(spec,
                                                                  whole)
    cfg = get_config(LM_DENSE_ARCH)
    params = lm_init(torch.Generator(device=dev).manual_seed(LM_SEED + 22),
                     cfg, dev)
    with exact_bf16():
        out["pipeline"] = shard_pipeline(dev, cfg, params, mesh)
    out["collectives"] = shard_collectives(dev, mesh)
    out["elastic"] = shard_elastic(dev, params, mesh)
    del params
    torch.cuda.empty_cache()
    out["compression"] = shard_compression(dev, mesh)
    dist.destroy_process_group()      # the one-rank group 8g.1 made
    out["seconds"] = time.perf_counter() - t0
    print(f"shard phase: {out['seconds']:.1f} s", flush=True)
    return out


def shard_launches(shard: dict, name: str) -> dict:
    """A kernel's launches on each path of phase 8g, each counted from 0
    (the two processes' per rank)."""
    counts = {}
    for label, r in shard.items():
        if isinstance(r, dict) and "launches" in r:
            counts[label] = r["launches"].get(name, 0)
        elif isinstance(r, dict):
            for sub, rr in r.items():
                if isinstance(rr, dict) and "launches" in rr:
                    counts[f"{label}, {sub}"] = rr["launches"].get(name, 0)
    return counts


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(t.full_tensor() if hasattr(
        t, "full_tensor") else t).all()) for t in tree_leaves_nt(tree)
        if isinstance(t, torch.Tensor) and t.is_floating_point())


def _whole(tree):
    """Every DTensor leaf of `tree` as the full tensor."""
    return tree_map_with_path(lambda _, t: t.full_tensor() if hasattr(
        t, "full_tensor") else t, tree)


def launch_agree(got, want, train: bool, dtype, label: str) -> float:
    """Hold the DTensor run's outputs against the plain run's: a train
    step by check_step (returns its worst parameter error), any other
    cell by LAUNCH_REL_TOL over its floating leaves (returns the worst
    error relative to the leaf's largest magnitude)."""
    if train:
        return check_step(got, want, dtype, label)["params"]
    worst = 0.0
    pairs = [(g, w) for g, w in zip(tree_leaves_nt(got),
                                    tree_leaves_nt(want))
             if isinstance(w, torch.Tensor) and w.is_floating_point()]
    if not pairs:
        raise AssertionError(f"{label}: no floating output to compare")
    for g, w in pairs:
        top = float(w.float().abs().max())
        err = float((g.float() - w.float()).abs().max()) / max(top, 1e-30)
        if not err <= LAUNCH_REL_TOL:
            raise AssertionError(f"{label}: DTensor run off the plain run "
                                 f"by {err:.3e} of {top:.3e}")
        worst = max(worst, err)
    return worst


def launch_real(arch: str, shape: str, mesh, dry: dict, dev) -> dict:
    """build_cell's fn at (arch, shape) on the one-rank mesh, weights and
    inputs drawn by numpy (make_args), laid out by its in_shardings:
    FlopCounterMode's count of the run must equal the 1 x 1 dry run's,
    and its outputs the same fn's on the plain tensors (launch_agree);
    then the step timed on the DTensor args and on the plain tensors
    (one call each after the counted one)."""
    cell = build_cell(arch, shape, mesh)
    cfg = get_config(arch)
    train = get_shape(cfg, shape).kind == "train"
    t0 = time.perf_counter()
    plain = cell.make_args(np.random.default_rng(LAUNCH_SEED), dev)
    args = reshard(plain, cell.in_shardings)
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with implicit_replication(), FlopCounterMode(display=False) as fc:
        out = cell.fn(*args)
    torch.cuda.synchronize()
    launches = launch_counts()
    flops = fc.get_total_flops()
    peak = torch.cuda.max_memory_allocated()
    if flops != dry["flops"]:
        raise AssertionError(f"launch {arch} x {shape}: real run counts "
                             f"{flops} FLOPs, the dry run {dry['flops']}")
    if not _finite(out):
        raise AssertionError(f"launch {arch} x {shape}: non-finite output")
    err = launch_agree(_whole(out), cell.fn(*plain), train, cfg.dtype,
                       f"launch {arch} x {shape}")
    del out

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        del r
        return (time.perf_counter() - t) * 1e3

    with implicit_replication():
        dt_ms = timed(lambda: cell.fn(*args))
    plain_ms = timed(lambda: cell.fn(*plain))
    r = {"flops": flops, "dry_flops": dry["flops"], "init_s": init_s,
         "dtensor_ms": dt_ms, "plain_ms": plain_ms,
         "tflops_plain": flops / plain_ms / 1e9,
         "tflops_dtensor": flops / dt_ms / 1e9,
         "max_memory_allocated": peak,
         "dry_bytes_per_device": dry["bytes_per_device"],
         "dtensor_vs_plain": err,
         "launches": {k: v for k, v in launches.items() if v}}
    print(f"launch real {arch} x {shape}: flops {flops:.4e} (= dry run), "
          f"DTensor vs plain {err:.3e} "
          f"({'check_step, params' if train else 'of the largest'}), "
          f"{plain_ms:.2f} ms plain ({r['tflops_plain']:.1f} TFLOP/s), "
          f"{dt_ms:.2f} ms on DTensors ({r['tflops_dtensor']:.1f} "
          f"TFLOP/s), peak {peak / 2**30:.3f} GiB vs dry "
          f"bytes_per_device {dry['bytes_per_device'] / 2**30:.3f} GiB, "
          f"numpy init {init_s:.1f} s", flush=True)
    del args, plain
    torch.cuda.empty_cache()
    return r


def launch_body() -> dict:
    """Phase 8h's body, in a process of its own (`chip_smoke.py
    --phase-8h`): (a) dry runs of LAUNCH_DRY_CELLS on the "fake" world's
    (16, 16) mesh with fake tensors on the card, and of
    LAUNCH_REAL_CELLS on a 1 x 1 mesh of it; the fake group torn down;
    (b) each real cell on a one-rank NCCL mesh (launch_real). Counters
    set to 0 just before each real run and read just after: no kernel
    lies on these paths (impl="xla", as the reference's)."""
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    out = {"dry": {}, "one": {}, "real": {}}
    dryrun.fake_world()
    for arch, shape in LAUNCH_DRY_CELLS:
        r = dryrun.run_cell(arch, shape, device=dev, verbose=False)
        print(f"launch dry {json.dumps(r)}", flush=True)
        out["dry"][f"{arch}|{shape}"] = r
    one = dryrun.one_rank_mesh(dev)
    for arch, shape in LAUNCH_REAL_CELLS:
        out["one"][f"{arch}|{shape}"] = dryrun.run_cell(
            arch, shape, mesh=one, device=dev, verbose=False)
    dist.destroy_process_group()
    out["dry_s"] = time.perf_counter() - t0
    mesh = make_debug_mesh()
    for arch, shape in LAUNCH_REAL_CELLS:
        out["real"][f"{arch}|{shape}"] = launch_real(
            arch, shape, mesh, out["one"][f"{arch}|{shape}"], dev)
    dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    return out


def launch_phase() -> dict:
    """Phase 8h: launch_body in a subprocess (its fake process group
    must not meet phase 8g's); returns its numbers and each real run's
    launches (all must be 0)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--phase-8h"],
        capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S)
    for line in proc.stdout.splitlines()[:-1]:
        print(line, flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 8h failed (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    out = json.loads(proc.stdout.splitlines()[-1])
    for label, r in out["real"].items():
        expect_launches(r["launches"], {}, f"launch {label}")
    out["wall_s"] = time.perf_counter() - t0
    print(f"launch phase: {out['wall_s']:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _lib.library()
    print(f"build: {_lib.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(_lib.build_log().strip(), flush=True)
    mma = sass_mma_counts(_lib.library_path())
    print(f"tensor-core instructions in the SASS (cuobjdump): "
          f"{json.dumps(mma) if mma else 'not measured (no cuobjdump)'}",
          flush=True)
    if mma:
        idle = [k for k in TENSOR_CORE_KERNELS
                if not (mma.get(k, {}).get("HGMMA") or mma.get(k, {}).get(
                    "HMMA"))]
        if idle:
            raise AssertionError(f"no tensor-core instructions in {idle}")

    rows = kernel_phase(dev)
    rows.update(threefry_phase(dev))
    rows.update(new_kernel_phase(dev))
    rows.update(dense_phase(dev))
    small_parity_phase()
    spec = FleetRunSpec(
        provider="detector", n_cameras=N_CAMERAS, n_steps=N_STEPS,
        shortlist_k=SHORTLIST_K,
        provider_kwargs={"det_cfg": get_config("madeye-approx")})
    main_result, counts, calls, oracle_calls = main_path_phase(spec)
    rows["oracle_pass"] = oracle_phase(oracle_calls)
    rows.update(search_phase(calls))
    frozen_s = main_result.timings["steady_s"]
    whole = _fleet_summary(main_result)
    del main_result
    # the learning path: head-only (the paper's mode) at the cell's
    # depth; full-param at 3 steps, cut in depth only to keep the
    # script inside its time limit
    distill_phase(dataclasses.replace(spec, distill=DistillSpec(),
                                      metrics=MetricsSpec()),
                  frozen_s, dev, "distill path")
    distill_phase(dataclasses.replace(
        spec, n_steps=FULL_STEPS, distill=DistillSpec(head_only=False),
        metrics=MetricsSpec()), frozen_s * FULL_STEPS / N_STEPS, dev,
        f"distill path, full mode (depth cut to {FULL_STEPS} steps)")
    distill_parity_phase()
    # this slice's paths: the unfused detector reference and its anchor,
    # materialized tables, the serving engine, the host fine-tune, the
    # examples
    slice_paths = unfused_phase(spec, frozen_s)
    slice_paths["materialized tables"] = tables_phase(dev)
    slice_paths["run_fleet_detector_controller"] = engine_phase(dev)
    continual_phase(dev)
    examples_phase()
    random_search_phase(dev)
    vit_row, dets = vit_flash_phase(spec)
    counts["flash_attention"] = vit_row["launches"]
    api_counts = kernel_api_phase(dev, dets)
    for name in ("box_iou", "frame_delta", "rmsnorm"):
        counts[name] = api_counts[name]
    beyond_limits_phase(dev)
    served = serve_phase(dev)
    torch.cuda.empty_cache()
    lm = lm_phase(dev)
    torch.cuda.empty_cache()
    zoo = zoo_phase(dev)
    torch.cuda.empty_cache()
    trained = train_phase(dev)
    torch.cuda.empty_cache()
    shard = shard_phase(dev, spec, whole)
    torch.cuda.empty_cache()
    launched = launch_phase()

    kernels = []
    for name, r in rows.items():
        src, replaces = SOURCES[name]
        # launches: the detector main path's; the serving launcher's
        # paths (each counted from 0) and the search kernels' device
        # times on the tables episodes' last steps ride beside them
        served_launches = {label: c.get(name, 0)
                           for label, c in served["paths"].items()
                           if c.get(name, 0)}
        tables_graph_ms = {label: rr[name]["graph_ms"]
                           for label, rr in served["rows"].items()
                           if name in rr}
        slice_launches = {label: c[name] for label, c in slice_paths.items()
                          if name in MAIN_PATH_KERNELS}
        # flash_attention inside the LMs (phase 8d): its launches on each
        # LM path and its rows at the two models' shapes
        # and inside the ViTs (phase 8e): its launches on each ViT path
        # and its rows at ViT-H/14's and ViT-B/16's shapes
        lm_extra = {} if name != "flash_attention" else {
            "lm_launches": lm["launches"],
            "lm_rows": _row_json(lm["rows"]),
            "zoo_launches": zoo["launches"],
            "zoo_rows": _row_json(zoo["rows"])}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library_ms"),
            **({"graph_ms": r["graph_ms"]} if "graph_ms" in r else {}),
            # phase 3: crop_patchify at the swinb-f32-k18 cell's shape
            **({"swin_b": {key: r["swin_b"][key] for key in (
                "launches", "max_abs_err", "ms", "plain_ms")}
                | {"bound_ms": r["swin_b"]["bound"][0],
                   "bound_by": r["swin_b"]["bound"][1]}}
               if "swin_b" in r else {}),
            # phase 3: dense at its five shapes
            **({"shapes": r["shapes"]} if "shapes" in r else {}),
            **({"serve_launches": served_launches}
               if served_launches else {}),
            **({"tables_graph_ms": tables_graph_ms}
               if tables_graph_ms else {}),
            **({"slice_launches": slice_launches}
               if slice_launches else {}),
            # phase 8f: the train paths, each counted from 0 (none
            # launches a kernel: the losses run the plain attention)
            "train_launches": {label: c.get(name, 0)
                               for label, c in trained["launches"].items()},
            # phase 8g: the sharding paths, each counted from 0
            "shard_launches": shard_launches(shard, name),
            # phase 8h: the launchers' real runs, each counted from 0
            # (none launches a kernel: the cells run impl="xla")
            "launch_launches": {
                label: r["launches"].get(name, 0)
                for label, r in launched["real"].items()},
            **lm_extra})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--phase-8h"]:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: no CUDA device is available")
        print(json.dumps(launch_body(), default=str), flush=True)
        sys.exit(0)
    sys.exit(main())
