"""Batched builds and bi-criteria auto-tuning (counterpart of
``repro.tune``).

* :mod:`~repro_torch.tune.batched` — ``build_many`` (one spec, many
  tables; host, batched device and fast fits) and ``build_grid`` (many
  specs, one table), stacked into :class:`BatchedIndexes`.
* :mod:`~repro_torch.tune.pareto` — registry-derived candidate grids, the
  measured time-space Pareto frontier (timed on the search kernels), and
  ``best_spec_for_budget``: the paper's bi-criteria selection over every
  kind.
* :mod:`~repro_torch.tune.mining` — the SY-RMI/CDFShop mining procedure
  on the batched builder.
* :mod:`~repro_torch.tune.rebuild` — ``RebuildPolicy`` + ``TunedTier``:
  serving-side drift detection, in-place shard swaps, full re-tunes,
  fence rebalances, and their counters in :mod:`repro_torch.obs`.
* :mod:`~repro_torch.tune.device_fit` — the one-program shard refresh
  (``device_refresh``) for PGM and RS tiers
  (``RebuildPolicy(device_refresh=True)`` opts a tier in).
"""

from . import batched, device_fit, mining, pareto, rebuild
from .batched import (
    BATCH_BACKENDS,
    FAST_KINDS,
    FITS,
    VMAP_KINDS,
    BatchedIndexes,
    build_grid,
    build_many,
)
from .device_fit import DEVICE_FITS, DEVICE_REFRESH_KINDS, device_refresh
from .mining import cdfshop_grid, mine_sy_rmi
from .pareto import (
    Candidate,
    best_candidate_for_budget,
    best_spec_for_budget,
    candidate_grid,
    frontier_report,
    pareto_frontier,
    report_specs,
    sweep,
)
from .rebuild import RebuildPolicy, TunedTier

__all__ = [
    "batched",
    "device_fit",
    "mining",
    "pareto",
    "rebuild",
    "BATCH_BACKENDS",
    "DEVICE_FITS",
    "DEVICE_REFRESH_KINDS",
    "FAST_KINDS",
    "FITS",
    "VMAP_KINDS",
    "device_refresh",
    "BatchedIndexes",
    "build_grid",
    "build_many",
    "cdfshop_grid",
    "mine_sy_rmi",
    "Candidate",
    "best_candidate_for_budget",
    "best_spec_for_budget",
    "candidate_grid",
    "frontier_report",
    "pareto_frontier",
    "report_specs",
    "sweep",
    "RebuildPolicy",
    "TunedTier",
]
