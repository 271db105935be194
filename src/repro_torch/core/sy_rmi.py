"""SY-RMI — the Synoptic RMI (counterpart of ``repro.core.sy_rmi``).

``cdfshop_sweep`` builds a deterministic grid of two-level RMIs,
``mine_ub`` takes the median branching factor per byte of model space,
and ``build_sy_rmi`` instantiates the winner architecture at
``b = UB x budget`` for a space budget given as a % of the table bytes.
The timing-driven winner pick waits for the tuner.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

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


def build_sy_rmi(
    table_np: np.ndarray, space_pct: float, ub: float, winner_root: str = "linear"
) -> RMIModel:
    """Instantiate the synoptic RMI for a space budget (% of table bytes)."""
    budget = space_pct / 100.0 * len(table_np) * 8
    b = max(2, int(budget * ub))
    m = build_rmi(table_np, b=b, root_type=winner_root)
    m.name = f"SY-RMI[{space_pct}%]"
    return m
