"""CDF / rank utilities shared by every model (counterpart of ``repro.core.cdf``).

A sorted table ``A[0..n)`` of uint64 keys induces the empirical CDF
``rank(x) = #{i : A[i] <= x}``; predecessor search returns
``rank(x) - 1`` (``-1`` when ``x < A[0]``).  Every model predicts an
interval ``[lo, hi]`` guaranteed to contain the predecessor; the
reduction factor (paper §2) measures how much of the table a prediction
discards.
"""

from __future__ import annotations

import numpy as np
import torch

from .keys import as_keys, to_f64

KEY_DTYPE = np.uint64
POS_DTYPE = np.int64


def as_table(keys) -> np.ndarray:
    """Sorted, deduplicated uint64 table (host side)."""
    arr = np.asarray(keys, dtype=KEY_DTYPE)
    return np.unique(arr)  # sorts and dedups


def keys_to_unit(keys: np.ndarray, kmin: np.uint64, kmax: np.uint64) -> np.ndarray:
    """Map uint64 keys into [0, 1] f64 for regression (host side)."""
    span = np.float64(kmax - kmin)
    if span == 0:
        span = 1.0
    return (keys.astype(np.float64) - np.float64(kmin)) / span


def keys_to_unit_torch(keys: torch.Tensor, kmin, inv_span) -> torch.Tensor:
    """The same map on encoded key tensors, ``inv_span = 1/(kmax-kmin)``
    precomputed; ``kmin`` is an encoded key tensor (the reference's
    ``keys_to_unit_jnp``)."""
    return (to_f64(keys) - to_f64(kmin)) * inv_span


def true_ranks(table: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Oracle predecessor ranks via numpy."""
    return np.searchsorted(table, queries, side="right").astype(POS_DTYPE) - 1


def reduction_factor(interval_lo, interval_hi, n: int) -> float:
    """Paper §2: average % of the table discarded by the model's
    predictions.  ``interval_lo/hi`` are inclusive bounds per query
    (tensors or host arrays); clipped intervals count their clipped
    length."""
    lo = np.asarray(torch.as_tensor(interval_lo).cpu(), dtype=np.float64)
    hi = np.asarray(torch.as_tensor(interval_hi).cpu(), dtype=np.float64)
    lengths = np.clip(hi - lo + 1.0, 1.0, float(n))
    return float(100.0 * (1.0 - lengths.mean() / float(n)))


def model_reduction_factor(model, table_np: np.ndarray, queries_np: np.ndarray) -> float:
    """Paper §2 empirical reduction factor of a model on a query batch.

    ``model`` is anything with the shared ``intervals(table, queries)``
    query surface: an :class:`repro_torch.index.Index` (queried on its
    device) or a core model (on the CPU)."""
    dev = getattr(model, "device", "cpu")
    lo, hi = model.intervals(as_keys(table_np, dev), as_keys(queries_np, dev))
    return reduction_factor(lo, hi, len(table_np))


def verified_max_error(predictions: np.ndarray, ranks: np.ndarray) -> int:
    """Max |prediction - rank| over the table's own keys (build-time)."""
    return int(np.max(np.abs(np.round(predictions) - ranks)))


def ceil_log2(n: int) -> int:
    n = max(int(n), 1)
    return max(1, int(np.ceil(np.log2(n)))) if n > 1 else 1
