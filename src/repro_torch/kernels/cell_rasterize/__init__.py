from repro_torch.kernels.cell_rasterize.ops import (
    cell_rasterize,
    cell_rasterize_plain,
    window_arrays,
)
