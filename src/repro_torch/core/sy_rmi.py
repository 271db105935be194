"""SY-RMI — the Synoptic RMI (counterpart of ``repro.core.sy_rmi``).

Pipeline, after the paper's §3.2/§4:
  1. ``cdfshop_sweep`` — a deterministic stand-in for CDFShop: up to 10
     two-level RMIs per table over a (root type x branching factor) grid.
  2. ``mine_ub`` — for the whole set of swept models, UB = median of
     (branching factor) / (model space bytes).
  3. ``pick_winner`` — relative-majority architecture by measured query
     time over a 1% simulation query set (paper §4).
  4. ``build_sy_rmi`` — given a space budget (a % of the table bytes),
     instantiate the winner architecture with b = UB x budget.

``mine_sy_rmi`` runs the whole procedure on the tuner's batched builder
(:func:`repro_torch.tune.mining.mine_sy_rmi`, imported lazily so this
module stays free of upward dependencies).  ``build_sy_rmi`` backs the
``SY-RMI`` kind in :mod:`repro_torch.index`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from repro_torch.device import resolve_device, wait_for
from repro_torch.obs.timing import stopwatch

from .keys import encode
from .rmi import ROOT_TYPES, RMIModel, build_rmi


def cdfshop_sweep(table_np: np.ndarray, max_models: int = 10):
    """Deterministic CDFShop analogue: grid of 2-level RMIs (roots x
    geometric branching factors), thinned to ``max_models``."""
    n = len(table_np)
    bs = [b for b in (64, 256, 1024, 4096, 16384, 65536, 262144) if b <= max(n // 2, 2)]
    combos = [(root, b) for root in ROOT_TYPES for b in bs]
    if len(combos) > max_models:
        idx = np.linspace(0, len(combos) - 1, max_models).astype(int)
        combos = [combos[i] for i in idx]
    return [build_rmi(table_np, b=b, root_type=root) for root, b in combos]


def mine_ub(models: Sequence[RMIModel]) -> float:
    """UB = median branching factor per byte of model space."""
    return float(np.median([m.b / m.space_bytes() for m in models]))


def measure_query_time(model, table_t, queries_t, reps: int = 3) -> float:
    """Best-of-``reps`` per-query wall time of ``model.predecessor`` (the
    windows and bounded search as tensor ops; the reference jits the same
    pipeline), each call followed by a wait for the card.  ``table_t`` and
    ``queries_t`` are encoded key tensors on one device."""
    wait_for(model.predecessor(table_t, queries_t))
    best = np.inf
    for _ in range(reps):
        sw = stopwatch()
        wait_for(model.predecessor(table_t, queries_t))
        best = min(best, sw.elapsed)
    return best / queries_t.shape[0]


def pick_winner(models: Sequence[RMIModel], table_np: np.ndarray, queries_np: np.ndarray,
                device=None):
    """Relative-majority winner by query time on the 1% simulation set,
    timed on ``device`` (default: the card): ``(winner root type,
    per-model seconds a query)``."""
    dev = resolve_device(device)
    table_t = encode(np.asarray(table_np, dtype=np.uint64), dev)
    q_t = encode(np.asarray(queries_np, dtype=np.uint64), dev)
    times = [measure_query_time(m, table_t, q_t) for m in models]
    best = int(np.argmin(times))
    return models[best].root_type, times


@dataclass
class SyRMIResult:
    ub: float
    winner_root: str
    sweep_sizes: list
    sweep_times: list
    mining_time: float


def mine_sy_rmi(
    tables: Sequence[np.ndarray],
    query_frac: float = 0.01,
    n_queries: int = 1_000_000,
    seed: int = 0,
    max_models: int = 10,
    device=None,
) -> SyRMIResult:
    """Full mining pass over a set of same-tier tables (paper §4).

    Delegates to :func:`repro_torch.tune.mining.mine_sy_rmi`: the CDFShop
    grid is built by the batched grid builder and timed on the search
    kernels, so mining and Pareto tuning share one engine.  ``device``
    defaults to the card."""
    from repro_torch.tune.mining import mine_sy_rmi as _mine

    return _mine(
        tables,
        query_frac=query_frac,
        n_queries=n_queries,
        seed=seed,
        max_models=max_models,
        device=device,
    )


def build_sy_rmi(
    table_np: np.ndarray, space_pct: float, ub: float, winner_root: str = "linear"
) -> RMIModel:
    """Instantiate the synoptic RMI for a space budget (% of table bytes)."""
    budget = space_pct / 100.0 * len(table_np) * 8
    b = max(2, int(budget * ub))
    m = build_rmi(table_np, b=b, root_type=winner_root)
    m.name = f"SY-RMI[{space_pct}%]"
    return m
