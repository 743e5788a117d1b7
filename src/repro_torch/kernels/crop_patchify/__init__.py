from repro_torch.kernels.crop_patchify.ops import (
    crop_patchify,
    crop_patchify_batch,
    crop_patchify_plain,
    render_crops_plain,
)
