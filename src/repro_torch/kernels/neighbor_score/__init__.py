from repro_torch.kernels.neighbor_score.ops import (
    geometry_arrays,
    neighbor_score_batch,
    neighbor_score_plain,
    neighbor_scores,
)
