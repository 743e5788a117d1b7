"""Host-side configuration copies (numpy) and the EWMA labels (torch)."""
from repro_torch.core.grid import DEFAULT_GRID, OrientationGrid
from repro_torch.core.path import prim_mst
from repro_torch.core.rank import TASKS, Query, Workload
from repro_torch.core.search import SearchConfig, best_rect, seed_shape
from repro_torch.core.tradeoff import BudgetConfig
from repro_torch.core.zoom import ZoomConfig
