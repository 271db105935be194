"""SY-RMI mining on the batched builder (counterpart of
``repro.tune.mining``; paper §3.2/§4, Figure 4).

The mining procedure runs through the tuner's machinery, so mining and
Pareto tuning share one engine:

* the CDFShop sweep is a grid of :class:`~repro_torch.index.RMISpec`\\ s
  built by :func:`repro_torch.tune.batched.build_grid`: every root type
  at one branching factor shares one device leaf fit;
* query timing goes through ``Index.lookup(backend="kernel")``, the
  hand-written RMI search kernel on the card (the reference times its
  default ``"xla"`` path; the port's default path is the kernel);
* UB mining reads ``b`` / ``space_bytes`` off the built indexes.

``mine_sy_rmi`` keeps the reference's signature and
:class:`~repro_torch.core.sy_rmi.SyRMIResult` shape;
``repro_torch.core.sy_rmi.mine_sy_rmi`` delegates here.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core import keys as keymod
from repro_torch.core.rmi import ROOT_TYPES
from repro_torch.core.sy_rmi import SyRMIResult
from repro_torch.index.index import resolve_device
from repro_torch.index.specs import RMISpec
from repro_torch.obs.timing import stopwatch

from .batched import build_grid
from .pareto import _time_lookup


def cdfshop_grid(n: int, max_models: int = 10) -> list:
    """Deterministic CDFShop analogue as a spec grid: roots x geometric
    branching factors, thinned to ``max_models`` with coverage of both
    axes (the paper uses CDFShop's ~10 models per table)."""
    bs = [b for b in (64, 256, 1024, 4096, 16384, 65536, 262144) if b <= max(n // 2, 2)]
    combos = [(root, b) for root in ROOT_TYPES for b in bs]
    if len(combos) > max_models:
        idx = np.linspace(0, len(combos) - 1, max_models).astype(int)
        combos = [combos[i] for i in idx]
    return [RMISpec(b=b, root_type=root) for root, b in combos]


def mine_ub(candidates) -> float:
    """UB = median branching factor per byte of model space (§3.2)."""
    ratios = [c.b / c.space_bytes() for c in candidates]
    return float(np.median(ratios))


def pick_winner(candidates, table_np: np.ndarray, queries_np: np.ndarray, reps: int = 3):
    """Relative-majority winner by query time on the simulation set, timed
    on ``"kernel"`` on the candidates' device: ``(root type, per-model
    seconds a query)``.  Timing only: a candidate's ranks are not checked
    here."""
    dev = candidates[0].device
    table_t = keymod.encode(np.asarray(table_np, dtype=np.uint64), dev)
    q_t = keymod.encode(np.asarray(queries_np, dtype=np.uint64), dev)
    times = [_time_lookup(c, table_t, q_t, "kernel", reps) / len(queries_np) for c in candidates]
    best = int(np.argmin(times))
    return candidates[best].root_type, times


def mine_sy_rmi(
    tables: Sequence[np.ndarray],
    query_frac: float = 0.01,
    n_queries: int = 1_000_000,
    seed: int = 0,
    max_models: int = 10,
    device=None,
) -> SyRMIResult:
    """Full mining pass over a set of same-tier tables (paper §4), built
    and timed on ``device`` (default: the card).  The simulation queries
    come from ``np.random.default_rng(seed)`` as in the reference, so
    both packages time the same keys."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    sw = stopwatch()
    all_cands, votes, sizes, times_all = [], [], [], []
    for table in tables:
        table = np.asarray(table, dtype=np.uint64)
        specs = cdfshop_grid(len(table), max_models=max_models)
        cands = build_grid(specs, table, fit="auto", device=dev)
        all_cands.extend(cands)
        nq = max(16, int(n_queries * query_frac))
        queries = rng.choice(table, size=nq, replace=True)
        winner, times = pick_winner(cands, table, queries)
        votes.append(winner)
        sizes.append([c.space_bytes() for c in cands])
        times_all.append(times)
    ub = mine_ub(all_cands)
    roots, counts = np.unique(votes, return_counts=True)
    winner_root = str(roots[np.argmax(counts)])
    return SyRMIResult(
        ub=ub,
        winner_root=winner_root,
        sweep_sizes=sizes,
        sweep_times=times_all,
        mining_time=sw.elapsed,
    )
