"""Host-side MadEye pieces (numpy) and the EWMA labels (torch).

  grid.py       orientation grid geometry (pan x tilt x zoom)
  ewma.py       EWMA orientation labels over a [F, N] fleet batch (torch)
  search.py     contiguous-shape evolution (head/tail swap algorithm)
  neighbor.py   bbox-centroid neighbor-candidate scoring
  path.py       precomputed-MST TSP 2-approx reachability + path selection
  zoom.py       bbox-clustering zoom controller (3 s auto zoom-out)
  rank.py       per-task predicted workload accuracy + ranking
  tradeoff.py   explore-vs-transmit budget balancer
  transport.py  the AR(1) mobile link model
  baselines.py  one-time/best-fixed/best-dynamic/Panoptes/tracking/UCB1
  madeye.py     the single-camera MadEyeController gluing it all per step

The fleet step (repro_torch.fleet) reads the configs and geometry here;
the numpy controller is what the serving launcher prints beside it.
"""
from repro_torch.core.grid import DEFAULT_GRID, OrientationGrid
from repro_torch.core.path import prim_mst
from repro_torch.core.rank import TASKS, Query, Workload
from repro_torch.core.search import SearchConfig, best_rect, seed_shape
from repro_torch.core.tradeoff import BudgetConfig
from repro_torch.core.zoom import ZoomConfig
from repro_torch.core.madeye import MadEyeController, Observation, StepResult
