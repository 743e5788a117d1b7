"""Hand-written CUDA kernels of the port (sources in repro_torch/csrc),
each with a plain PyTorch version beside its wrapper:

  neighbor_score   candidate scoring inside the shape-search loops
  cell_rasterize   boxes -> (cell x zoom) oracle tables, once per step
  crop_patchify    shortlisted crops -> ViT patch tokens, once per step

`_lib` builds them with nvcc at the first launch and counts launches.
"""
from repro_torch.kernels._lib import (
    KERNELS,
    launch_counts,
    reset_launch_counts,
)
