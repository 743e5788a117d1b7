from repro_torch.kernels.shape_search.ops import (
    budget_walk_batch,
    budget_walk_plain,
    shape_search_batch,
    shape_search_plain,
)
