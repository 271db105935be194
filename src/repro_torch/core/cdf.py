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


def sorted_unique(values) -> np.ndarray:
    """The sorted distinct values of a flat array: what ``np.unique``
    returns, from one ``np.sort`` and a mask of adjacent differences.
    On numpy 2.3, ``np.unique`` of tens of millions of uint64 keys can take
    a hundred times as long as their sort (PERF.md §7)."""
    s = np.sort(np.asarray(values).reshape(-1))
    if len(s) < 2:
        return s
    keep = np.empty(len(s), dtype=bool)
    keep[0] = True
    np.not_equal(s[1:], s[:-1], out=keep[1:])
    return s[keep]


def as_table(keys) -> np.ndarray:
    """Sorted, deduplicated uint64 table (host side)."""
    return sorted_unique(np.asarray(keys, dtype=KEY_DTYPE))


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


# ---------------------------------------------------------------------------
# Device helpers of the fits: exact integer logs, segment ids and reductions
# over sorted segment ids, and the corridor scans (one kernel launch a stack)
# ---------------------------------------------------------------------------

_LOW = {sh: (1 << (64 - sh)) - 1 for sh in (32, 16, 8, 4, 2, 1)}


def bit_length_device(x: torch.Tensor) -> torch.Tensor:
    """``int.bit_length`` of uint64 values held as int64 bit patterns (int32
    result), by exact binary-shift reduction: a logical shift (the
    arithmetic ``>>`` masked to its low bits, as
    :func:`repro_torch.kernels.rs_search.radix_prefix` does), so values of
    2^63 and more count 64 bits.  f64 ``log2`` would round above 2^53."""
    out = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for sh, low in _LOW.items():
        shifted = (x >> sh) & low
        has = shifted != 0
        out = out + torch.where(has, sh, 0).to(torch.int32)
        x = torch.where(has, shifted, x)
    return out + (x != 0).to(torch.int32)


def ceil_log2_device(x: torch.Tensor) -> torch.Tensor:
    """Tensor form of :func:`ceil_log2`: the smallest ``k >= 1`` with
    ``2**k >= x`` (int64), with exact integer shifts."""
    x = torch.clamp(x.to(torch.int64), min=2)
    return torch.clamp(bit_length_device(x - 1).to(torch.int64), min=1)


_I64_MAX = (1 << 63) - 1


def _row_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Integer cumulative sums along the last axis, taken as one scan of the
    flattened stack less each row's base (exact in int64): on the card a
    scan along a long row of a few rows runs far slower than one flat
    scan (8.5 ms against 0.45 ms for a search, at 4 x 2^22 keys)."""
    flat = torch.cumsum(x.reshape(-1).to(torch.int64), dim=0).reshape(x.shape)
    if x.dim() < 2:
        return flat
    base = torch.nn.functional.pad(flat[..., -1].reshape(-1)[:-1], (1, 0))
    return flat - base.reshape(*x.shape[:-1], 1)


def segment_ids(mask: torch.Tensor):
    """``(seg, start)`` for a boolean segment-start ``mask`` of shape
    ``(..., n)`` whose first element starts a segment: each element's
    segment id (dense, 0-based, int64) and each id's start index (capacity
    ``n``).  Unused ids hold the int64 maximum, the empty-segment identity
    of the reference's ``jax.ops.segment_min`` (its docstring says ``n``)."""
    seg = _row_cumsum(mask) - 1
    first, _ = _bounds(seg, mask.shape[-1])
    ids = torch.arange(mask.shape[-1], device=mask.device)
    return seg, torch.where(ids <= seg[..., -1:], first, _I64_MAX)


def _bounds(seg, n_seg: int):
    """``(first, end)`` element index of each id ``0 .. n_seg - 1`` of the
    sorted ids ``seg`` (``(..., n)``; an empty id gets ``first == end``):
    one search of the sorted ids, no atomics."""
    ids = torch.arange(n_seg + 1, device=seg.device).expand(*seg.shape[:-1], n_seg + 1)
    edges = torch.searchsorted(seg, ids.contiguous(), side="left")
    return edges[..., :-1], edges[..., 1:]


def _prefix_count(flags, first, end):
    """Integer sums of ``flags`` over each ``[first, end)`` (exact)."""
    csum = torch.nn.functional.pad(_row_cumsum(flags), (1, 0))
    return torch.gather(csum, -1, end) - torch.gather(csum, -1, first)


def _segment_extreme(values, seg, n_seg: int, reduce: str, identity: float):
    """Max or min of ``values`` over each id of the sorted ids ``seg``
    (``(..., n)``, ids in ``[0, n_seg)``); ``identity`` for an empty id.
    NaN propagates, as in ``jax.ops.segment_max``: the extremum runs over
    the values with NaN replaced by ``identity``, and an id that saw a NaN
    (counted exactly) gives NaN.  ``torch.segment_reduce`` over the
    flattened stack reduces each segment in a fixed order, with no atomic
    contention on a long segment."""
    first, end = _bounds(seg, n_seg)
    nan = torch.isnan(values)
    lengths = (end - first).reshape(-1)
    out = torch.segment_reduce(torch.where(nan, identity, values).reshape(-1), reduce,
                               lengths=lengths, unsafe=True, initial=identity)
    out = out.reshape(first.shape)
    return torch.where(_prefix_count(nan, first, end) > 0, float("nan"), out)


def segment_max(values, seg, n_seg: int, initial: float = float("-inf")):
    """``jax.ops.segment_max`` over sorted ids (``initial`` for an empty id;
    0 gives the reference's ``zeros.at[seg].max``)."""
    return _segment_extreme(values, seg, n_seg, "max", initial)


def segment_min(values, seg, n_seg: int):
    """``jax.ops.segment_min`` over sorted ids (+inf for an empty id)."""
    return _segment_extreme(values, seg, n_seg, "min", float("inf"))


def segment_count(weights, seg, n_seg: int):
    """Integer sums of ``weights`` over each id of the sorted ids ``seg``."""
    return _prefix_count(weights, *_bounds(seg, n_seg))


def segment_sum(values, lengths):
    """Float sums of consecutive segments of ``lengths`` (``(..., n_seg)``,
    summing to ``values.shape[-1]``), each summed in element order with
    ``torch.segment_reduce``: deterministic on the card, where a
    scatter-add's atomics would add in a run-dependent order, and on the
    CPU the sequential sum of ``np.bincount``."""
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=lengths.dim() - 1,
                                unsafe=True, initial=0.0)


def _as_rows(keys_f64, eps, count=None):
    """A stack of f64 key rows, one f64 ε (none for ``eps=None``) and
    (optionally) one int64 count a row, and whether the input was one
    table (to drop the axis again).  Pass ε as a tensor on the keys'
    device where no host sync may happen: a Python number is copied."""
    keys = torch.as_tensor(keys_f64, dtype=torch.float64)
    one = keys.dim() == 1
    keys = keys.reshape(-1, keys.shape[-1]).contiguous()
    rows = keys.shape[0]
    if eps is not None:
        eps = torch.as_tensor(eps, dtype=torch.float64, device=keys.device)
        eps = eps.reshape(-1).expand(rows).contiguous()
    if count is not None:
        count = torch.as_tensor(count, dtype=torch.int64, device=keys.device).reshape(-1)
        count = count.expand(rows).contiguous()
    return keys, eps, count, one


def chunked_corridor_scan(recurrence: str, keys, eps, length: int, count=None):
    """The exact greedy corridor fit: each row of ``keys`` walked through
    ``recurrence`` (``"pgm"`` or ``"rs"``, see
    :func:`repro_torch.kernels.corridor_scan.corridor_scan`) in one carry,
    one kernel launch for the stack.  The reference's takes the step
    function and streams the table through a ``lax.scan`` in chunks, which
    changes no flag; the kernel walks chunks in parallel and corrects them
    (:func:`repro_torch.kernels.corridor_scan.corridor_scan_exact`), which
    changes none either."""
    from repro_torch.kernels.corridor_scan import corridor_scan_exact

    return corridor_scan_exact(keys, eps, recurrence=recurrence, length=length, count=count)


def blocked_corridor_scan(recurrence: str, keys, eps, length: int, chunk: int, count=None):
    """The fast fit's blockwise scan: every ``chunk`` elements of a row
    start from a fresh carry (PGM's constant init, RS's re-anchor at the
    block's first point), all blocks of the stack in one kernel launch."""
    from repro_torch.kernels.corridor_scan import corridor_scan

    return corridor_scan(keys, eps, recurrence=recurrence, length=length,
                         chunk=max(int(chunk), 1), count=count)
