"""Sorted Table Search procedures (counterpart of ``repro.core.search``).

Every procedure is vectorised over a query batch of encoded keys
(sign-flipped int64, :mod:`repro_torch.core.keys`) and returns the
**predecessor rank** ``j = rank(x) - 1`` in ``[-1, n-1]``.  The
branch-free procedures (BFS, BFE, K-BFS) make a fixed number of trips,
Python loops of tensor ops.  The branchy ones (BBS, K-BBS) loop until
*every* query has converged (``active.any()``): the vectorised semantics
of the paper's scalar early exit, as the reference's ``while_loop`` has
them.  On the card each such trip syncs with the host once.

The bounded epilogues also take a stack of tables: a ``(N, m)`` table
with ``(N, B)`` queries and windows searches row ``i`` of the queries in
table ``i`` (the reference vmaps them), so a batched lookup is one pass
of tensor ops, not one per table.

Gathers: the reference's ``_take`` clips (``mode="clip"``), and so does
:func:`take_clip`.  :func:`take_fill` is ``jnp.take``'s default mode for
the index kinds' interval code: a negative index wraps once, any other
index out of range reads a fill value.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .cdf import ceil_log2
from .keys import to_f64

#: predecessor rank of a query below the table's smallest key
NO_PRED = -1

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
_TWO63 = 9.223372036854775808e18

#: the fill of an out-of-range read of a key leaf: uint64's largest value,
#: encoded
KEY_FILL = _I64_MAX


def _gather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[idx]`` for a ``(L,)`` array, or row-wise for a ``(N, L)``
    stack and ``(N, ...)`` indices; ``idx`` is in range."""
    if arr.dim() == 1:
        return arr[idx]
    return torch.gather(arr, 1, idx.reshape(arr.shape[0], -1)).reshape(idx.shape)


def one_table(window, q, *leaves, **statics):
    """A stacked-form ``*_window`` on one model's leaves: each leaf (a
    tensor or a number) gains a leading table axis of one and the queries
    become ``(1, B)``; the window comes back in ``q``'s shape."""
    lifted = (torch.as_tensor(x, device=q.device)[None] for x in leaves)
    lo, hi = window(q.reshape(1, -1), *lifted, **statics)
    return lo.reshape(q.shape), hi.reshape(q.shape)


def take_clip(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(arr, idx, mode="clip")``, row-wise for a stack."""
    return _gather(arr, torch.clamp(idx, 0, arr.shape[-1] - 1))


def take_fill(arr: torch.Tensor, idx: torch.Tensor, fill=None) -> torch.Tensor:
    """``jnp.take(arr, idx)`` in its default mode, row-wise for a stack:
    an index in ``[-L, 0)`` wraps, any other out of ``[0, L)`` reads
    ``fill`` (default: NaN for floats, the int64 minimum for integers;
    key leaves pass the encoded largest key, the fill of uint64)."""
    n = arr.shape[-1]
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    got = _gather(arr, torch.clamp(idx, 0, max(n - 1, 0)))
    if fill is None:
        fill = float("nan") if arr.dtype.is_floating_point else _I64_MIN
    return torch.where(inside, got, torch.full_like(got, fill))


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip``: ``min(max(x, lo), hi)``, each bound a number or a
    tensor (``hi`` wins where ``lo > hi``)."""
    x = torch.maximum(x, lo) if torch.is_tensor(lo) else x.clamp(min=lo)
    return torch.minimum(x, hi) if torch.is_tensor(hi) else x.clamp(max=hi)


def f64_to_i64(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 as XLA converts: toward zero, saturating at the
    int64 range, NaN to 0 (a plain cast of an out-of-range value is
    undefined and differs between the CPU and the card)."""
    big = x >= _TWO63
    safe = torch.where(torch.isnan(x) | big, 0.0, x).clamp(min=-_TWO63)
    return torch.where(big, _I64_MAX, safe.to(torch.int64))


# ---------------------------------------------------------------------------
# Branch-free binary search (BFS) — Algorithm 1 of the paper.
# ---------------------------------------------------------------------------


def bounded_upper_bound(table, q, lo, length, *, steps: int):
    """First index in [lo, lo+length) with table[i] > q; lo+length if none.

    Branch-free: exactly ``steps`` trips of the Khuong–Morin loop with
    ``<=`` compares.  ``steps`` must be >= ceil(log2(max length)).
    Zero-length windows return ``lo``."""
    base = lo.to(torch.int64)
    n = length.to(torch.int64)
    for _ in range(steps):
        half = n >> 1
        mid = base + half
        go_right = (take_clip(table, mid) <= q) & (n > 1)
        base = torch.where(go_right, mid, base)
        n = n - torch.where(n > 1, half, 0)
    ub = base + (take_clip(table, base) <= q).to(torch.int64)
    return torch.where(length > 0, ub, lo.to(torch.int64))


def bfs(table, q, *, n: int | None = None):
    """Branch-free Binary Search over the whole table -> predecessor rank."""
    n = int(table.shape[-1]) if n is None else n
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    ln = torch.full(q.shape, n, dtype=torch.int64, device=q.device)
    return bounded_upper_bound(table, q, lo, ln, steps=ceil_log2(n)) - 1


def bounded_bfs(table, q, lo, hi, *, max_window: int):
    """Predecessor rank given a guaranteed inclusive window [lo, hi].

    The learned-procedure epilogue: every model feeds its predicted
    interval here.  The predecessor rank must lie in [lo, hi] (lo may be
    -1, meaning "possibly before A[0]")."""
    n = table.shape[-1]
    lo_c = torch.clamp(lo.to(torch.int64), 0, n - 1)
    hi_c = torch.clamp(hi.to(torch.int64), 0, n - 1)
    length = torch.clamp(hi_c - lo_c + 1, min=0)
    return bounded_upper_bound(table, q, lo_c, length, steps=ceil_log2(max_window)) - 1


def bounded_bbs_branchy(table, q, lo, hi):
    """Branchy bounded epilogue (the paper's \\*-BBS variants): the
    equality-exit lo/hi loop over a guaranteed window [lo, hi], every
    query trips until all have converged.  The ``backend="bbs"`` path of
    every :class:`repro_torch.index.Index` kind."""
    n = table.shape[-1]
    res = torch.full(q.shape, NO_PRED, dtype=torch.int64, device=q.device)
    active = torch.ones(q.shape, dtype=torch.bool, device=q.device)
    lo = torch.clamp(lo.to(torch.int64), 0, n - 1)
    hi = torch.clamp(hi.to(torch.int64), 0, n - 1)
    while bool(active.any()):
        mid = (lo + hi) >> 1
        v = take_clip(table, mid)
        found = active & (v == q)
        res = torch.where(found, mid, res)
        go_right = v < q
        lo_n = torch.where(active & go_right, mid + 1, lo)
        hi_n = torch.where(active & ~go_right, mid - 1, hi)
        res = torch.where(active & ~found & (lo_n > hi_n), hi_n, res)
        active = active & ~found & (lo_n <= hi_n)
        lo, hi = lo_n, hi_n
    return res


def bounded_upper_bound_branchy(table, q, lo, count):
    """Branchy counterpart of :func:`bounded_upper_bound` for prefix
    windows: the number of keys ``<= q`` among ``table[lo : lo+count]``,
    in ``[0, count]``, through the early-exit loop (``count`` may be 0).
    Assumes unique keys within the window."""
    lo = lo.to(torch.int64)
    count = count.to(torch.int64)
    res = bounded_bbs_branchy(table, q, lo, lo + count - 1)
    return torch.minimum(torch.clamp(res - lo + 1, min=0), count)


# ---------------------------------------------------------------------------
# Branchy binary search (BBS).
# ---------------------------------------------------------------------------


def bbs(table, q, *, n: int | None = None):
    """Branchy Binary Search: the lo/hi loop with an equality exit; every
    query trips until all have converged."""
    n = int(table.shape[-1]) if n is None else n
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full(q.shape, n - 1, dtype=torch.int64, device=q.device)
    return bounded_bbs_branchy(table, q, lo, hi)


# ---------------------------------------------------------------------------
# Eytzinger layout (BFE) — supplementary Algorithm 3.
# ---------------------------------------------------------------------------


def eytzinger_layout(table_np):
    """Host-side: permute a sorted uint64 table into Eytzinger (BFS tree)
    order, padded to 2^h - 1 entries with the max key.  Returns
    ``(layout, inorder_rank, height)`` (numpy; encode the layout for
    :func:`bfe`)."""
    n = int(table_np.shape[0])
    h = max(1, int(math.ceil(math.log2(n + 1))))
    m = (1 << h) - 1
    pad = np.full(m, np.iinfo(np.uint64).max, dtype=np.uint64)
    pad[:n] = table_np
    k = np.arange(m, dtype=np.int64)
    d = np.floor(np.log2(k + 1)).astype(np.int64)  # depth
    # in-order rank of eytzinger node k in a perfect tree of height h
    rank = (2 * (k + 1 - (1 << d)) + 1) * (1 << (h - 1 - d)) - 1
    return pad[rank], rank, h


def bfe(layout, inorder_rank, q, *, height: int, n: int):
    """Branch-free Eytzinger search -> predecessor rank (paper Alg. 3).

    ``layout`` is the encoded Eytzinger table and ``inorder_rank`` its
    position -> sorted-rank map (:func:`eytzinger_layout`).  The walk
    computes the upper bound with ``q < A[i]``; the ffs trick recovers
    the successor's layout position."""
    i = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    for _ in range(height):
        i = torch.where(q < take_clip(layout, i), 2 * i + 1, 2 * i + 2)
    t = i + 1
    low_zero = (~t) & (t + 1)  # the lowest zero bit of t, a power of two
    _, exp = torch.frexp(low_zero.to(torch.float64))
    trailing_ones = exp.to(torch.int64) - 1
    j = t >> (trailing_ones + 1)
    m = layout.shape[-1]
    ub = torch.where(j == 0, m, take_clip(inorder_rank, torch.clamp(j - 1, min=0)))
    return torch.clamp(ub, max=n) - 1


# ---------------------------------------------------------------------------
# k-ary search (K-BFS, K-BBS) — supplementary Algorithm 2.
# ---------------------------------------------------------------------------


def _kary_step(table, q, base, n, frac, k: int):
    fence = base[..., None] + (frac * n[..., None]) // k
    seg = (take_clip(table, fence) <= q[..., None]).to(torch.int64).sum(-1)
    new_base = base + (seg * n) // k
    new_n = (torch.clamp(seg + 1, max=k) * n) // k - (seg * n) // k
    keep = n > 1
    return torch.where(keep, new_base, base), torch.where(keep, new_n, n)


def bounded_kary_upper_bound(table, q, lo, length, *, k: int, steps: int):
    """Upper bound by k-ary splitting: each step gathers k-1 fences and
    shrinks the window by ~k.  steps >= ceil(log_k(max length))."""
    base = lo.to(torch.int64)
    n = length.to(torch.int64)
    frac = torch.arange(1, k, dtype=torch.int64, device=q.device)
    for _ in range(steps):
        base, n = _kary_step(table, q, base, n, frac, k)
    ub = base + (take_clip(table, base) <= q).to(torch.int64)
    return torch.where(length > 0, ub, lo.to(torch.int64))


def kbfs(table, q, *, k: int = 6, n: int | None = None):
    """k-ary branch-free search -> predecessor rank (paper's K-BFS)."""
    n = int(table.shape[-1]) if n is None else n
    steps = max(1, int(math.ceil(math.log(max(n, 2)) / math.log(k))))
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    ln = torch.full(q.shape, n, dtype=torch.int64, device=q.device)
    return bounded_kary_upper_bound(table, q, lo, ln, k=k, steps=steps) - 1


def kbbs(table, q, *, k: int = 6, n: int | None = None):
    """Branchy k-ary search: trips until every window is one key wide."""
    n = int(table.shape[-1]) if n is None else n
    frac = torch.arange(1, k, dtype=torch.int64, device=q.device)
    base = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    ln = torch.full(q.shape, n, dtype=torch.int64, device=q.device)
    while bool((ln > 1).any()):
        base, ln = _kary_step(table, q, base, ln, frac, k)
    return base + (take_clip(table, base) <= q).to(torch.int64) - 1


# ---------------------------------------------------------------------------
# Interpolation search (IBS) and 3-point interpolation (TIP).
# ---------------------------------------------------------------------------


def _binary_epilogue(table, q, lo, hi, n: int):
    """After the interpolation rounds the predecessor is in [lo-1, hi]."""
    win_lo = torch.clamp(lo - 1, min=0)
    length = torch.clamp(hi - win_lo + 1, min=0)
    ub = bounded_upper_bound(table, q, win_lo, torch.clamp(length, min=1), steps=ceil_log2(n))
    return torch.where(length > 0, ub - 1, hi)


def ibs(table, q, *, n: int | None = None, max_steps: int = 16):
    """Interpolation search: ``max_steps`` fixed interpolation rounds with
    masking, then a branch-free binary epilogue on the surviving window."""
    n = int(table.shape[-1]) if n is None else n
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full(q.shape, n - 1, dtype=torch.int64, device=q.device)
    qe = to_f64(q)
    for _ in range(max_steps):
        a_lo = to_f64(take_clip(table, lo))
        a_hi = to_f64(take_clip(table, hi))
        denom = torch.clamp(a_hi - a_lo, min=1.0)
        pos = lo + f64_to_i64((qe - a_lo) * (hi - lo).to(torch.float64) / denom)
        pos = torch.minimum(torch.maximum(pos, lo), hi)
        go_right = take_clip(table, pos) <= q
        new_lo = torch.where(go_right, pos + 1, lo)
        new_hi = torch.where(go_right, hi, pos - 1)
        keep = lo <= hi
        lo, hi = torch.where(keep, new_lo, lo), torch.where(keep, new_hi, hi)
    return _binary_epilogue(table, q, lo, hi, n)


def tip(table, q, *, n: int | None = None, max_steps: int = 8, guard: int = 8):
    """Three-point interpolation (Van Sandt et al.), fixed rounds: quadratic
    interpolation of the key -> rank curve until the window is below
    ``guard``, then the branch-free epilogue."""
    n = int(table.shape[-1]) if n is None else n
    lo = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    hi = torch.full(q.shape, n - 1, dtype=torch.int64, device=q.device)
    qe = to_f64(q)
    for _ in range(max_steps):
        mid = (lo + hi) >> 1
        y0 = to_f64(take_clip(table, lo)) - qe
        y1 = to_f64(take_clip(table, mid)) - qe
        y2 = to_f64(take_clip(table, hi)) - qe
        dm = (mid - lo).to(torch.float64)
        d12 = torch.where(y1 == y2, 1.0, y1 - y2)
        num = y1 * dm * (1.0 + (y0 - y1) / d12)
        den = y0 - y2 * ((y0 - y1) / d12)
        expected = mid + f64_to_i64(num / torch.where(den == 0, 1.0, den))
        expected = torch.minimum(torch.maximum(expected, lo), hi)
        go_right = take_clip(table, expected) <= q
        new_lo = torch.where(go_right, expected + 1, lo)
        new_hi = torch.where(go_right, hi, expected - 1)
        keep = (hi - lo) > guard
        lo, hi = torch.where(keep, new_lo, lo), torch.where(keep, new_hi, hi)
    return _binary_epilogue(table, q, lo, hi, n)


# ---------------------------------------------------------------------------
# Registry of plain (model-free) procedures.
# ---------------------------------------------------------------------------

PROCEDURES = {
    "bfs": bfs,
    "bbs": bbs,
    "kbfs": kbfs,
    "kbbs": kbbs,
    "ibs": ibs,
    "tip": tip,
}
