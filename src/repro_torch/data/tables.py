"""Table tiers and query sampling (counterpart of ``repro.data.tables``).

The tier sizes keep the reference's names and key counts (named there
for a TPU's memory levels); on an H100, L4 (128 MiB of keys) is the tier
larger than the 50 MB L2 cache, so its table lives in HBM.
"""

from __future__ import annotations

import numpy as np

# tier name -> number of keys
TIERS = {
    "L1": 16_384,
    "L2": 262_144,
    "L3": 2_097_152,
    "L4": 16_777_216,
}


def make_queries(table: np.ndarray, n_queries: int, seed: int = 0) -> np.ndarray:
    """Paper §3.4: uniform with replacement from the table's elements."""
    rng = np.random.default_rng(seed + 7)
    return rng.choice(table, size=n_queries, replace=True)
