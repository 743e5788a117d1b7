"""Hand-written CUDA kernels of the port (sources in repro_torch/csrc),
each with a plain PyTorch version beside its wrapper:

  neighbor_score   candidate scoring (the kernel API; the main path
                   scores inside shape_search)
  shape_search     evolve + resize each camera's shape, once per step
  budget_walk      shrink each shape until its MST walk fits the time
                   budget, once per step
  cell_rasterize   boxes -> (cell x zoom) window tables (the kernel API;
                   the main path rasterizes inside oracle_pass)
  oracle_pass      the whole oracle pass (draws, rasterization, tables,
                   oracle accuracy), once per step
  crop_patchify    shortlisted crops -> ViT patch tokens, once per step
  flash_attention  online-softmax attention (the ViT's impl="flash")
  box_iou          dense IoU matrix under NMS and box matching
  frame_delta      per-tile change mask + int8 residual of a frame
  rmsnorm          fused RMSNorm over rows
  threefry         the threefry draws of scene/prng.py (keys, bits,
                   uniform, randint, normal), once per draw
  dense            act(x @ w + b) in float32: the models' linears
                   (layers.linear) on the card without gradients

`_lib` builds them with nvcc at the first launch and counts launches.
"""
from repro_torch.kernels._lib import (
    KERNELS,
    launch_counts,
    reset_launch_counts,
)
