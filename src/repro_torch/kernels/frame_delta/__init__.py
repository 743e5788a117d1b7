from repro_torch.kernels.frame_delta.ops import (
    apply_delta,
    frame_delta,
    frame_delta_plain,
    frame_delta_tiles,
)
