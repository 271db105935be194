"""CDF / rank utilities shared by every model (counterpart of ``repro.core.cdf``).

A sorted table ``A[0..n)`` of uint64 keys induces the empirical CDF
``rank(x) = #{i : A[i] <= x}``; predecessor search returns
``rank(x) - 1`` (``-1`` when ``x < A[0]``).
"""

from __future__ import annotations

import numpy as np

KEY_DTYPE = np.uint64
POS_DTYPE = np.int64


def as_table(keys) -> np.ndarray:
    """Sorted, deduplicated uint64 table (host side)."""
    arr = np.asarray(keys, dtype=KEY_DTYPE)
    return np.unique(arr)  # sorts and dedups


def true_ranks(table: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Oracle predecessor ranks via numpy."""
    return np.searchsorted(table, queries, side="right").astype(POS_DTYPE) - 1


def ceil_log2(n: int) -> int:
    n = max(int(n), 1)
    return max(1, int(np.ceil(np.log2(n)))) if n > 1 else 1
