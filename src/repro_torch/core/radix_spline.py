"""RadixSpline (counterpart of ``repro.core.radix_spline``).

GreedySplineCorridor: knots are actual (key, rank) points; a candidate
point is accepted while the slope from the current anchor stays inside
the corridor cone; on violation the previous point becomes a knot and the
cone restarts.  A radix table over the top ``r`` bits of ``key - kmin``
narrows the knot search.  The error bound is re-measured over every key
after the build, so the reported window is a guarantee under f64
rounding.  Host numpy, operation for operation as the reference.  The
query side (:func:`rs_window`, ``RSModel.intervals``) runs on encoded key
tensors.

The device fits take f64 key tensors, one table or a stack ``(N, n)``:
:func:`rs_knots_scan` (the exact corridor, one kernel launch a stack,
masks equal to :func:`spline_knots`'s knots) and :func:`rs_knots_fast`
(blocks re-anchored at every ``FAST_CHUNK``-th key, parity merge rounds
over the knots and a chord re-measure, :func:`rs_verified_eps`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.obs.timing import stopwatch

from . import search
from .cdf import (
    _as_rows,
    blocked_corridor_scan,
    ceil_log2,
    chunked_corridor_scan,
    segment_ids,
    segment_max,
)
from .keys import encode, to_f64
from .pgm import FAST_CHUNK, _merge_rounds
from .search import KEY_FILL, take_fill

_CHUNK = 4096


def rs_window(q, knot_keys, knot_ranks, radix_table, kmin, shift, eps_eff, m_valid, *,
              r_bits: int, n: int, steps: int):
    """Inclusive window of each encoded query over the table: the radix
    table at the query's prefix bounds the knot range, a ``steps``-trip
    search of it finds the knot ``j``, and the float64 line from knot
    ``j`` to ``j + 1`` at ``max(q, kmin)``, widened by ``eps_eff``, gives
    the window.  ``kmin`` is the encoded smallest key and ``shift`` the
    radix shift.  The leaves are a stack's (``(N,)`` scalars), the queries
    ``(N, B)``; one model is the stack of one (:func:`search.one_table`).

    The prefix is the unsigned ``(max(q, kmin) - kmin) >> shift`` clamped
    to the top bucket (:func:`repro_torch.kernels.rs_search.radix_prefix`,
    the kernel path's prefix).  The reference's interval code instead
    casts the unsigned prefix to int64 before clamping it, so with shift 0
    a query 2^63 or more above ``kmin`` lands in bucket 0 and its window
    can miss the rank (ROADMAP.md, queue 3)."""
    from repro_torch.kernels.rs_search import radix_prefix

    kmin, shift, eps_eff, m_valid = (x[:, None] for x in (kmin, shift, eps_eff, m_valid))
    qc = torch.maximum(q, kmin)
    prefix = radix_prefix(q, kmin, shift, r_bits).to(torch.int64)
    lo_k = torch.clamp(take_fill(radix_table, prefix) - 1, min=0)
    length = torch.clamp(take_fill(radix_table, prefix + 1) - lo_k, min=1)
    ub = search.bounded_upper_bound(knot_keys, q, lo_k, length, steps=steps)
    j = search.clip(ub - 1, 0, m_valid - 2)
    x1 = to_f64(take_fill(knot_keys, j, KEY_FILL))
    x2 = to_f64(take_fill(knot_keys, j + 1, KEY_FILL))
    y1 = take_fill(knot_ranks, j).to(torch.float64)
    y2 = take_fill(knot_ranks, j + 1).to(torch.float64)
    t = (to_f64(qc) - x1) / torch.clamp(x2 - x1, min=1.0)
    pred = y1 + torch.clamp(t, 0.0, 1.0) * (y2 - y1)
    lo = torch.floor(pred).to(torch.int64) - eps_eff
    hi = torch.ceil(pred).to(torch.int64) + eps_eff
    return torch.clamp(lo, 0, n - 1), torch.clamp(hi, 0, n - 1)


def spline_knots(keys_f64: np.ndarray, eps: int) -> np.ndarray:
    """Greedy corridor spline: knot indices (always with 0 and n-1)."""
    n = len(keys_f64)
    if n <= 2:
        return np.arange(n, dtype=np.int64)
    knots = [0]
    x0, y0 = keys_f64[0], 0.0
    lo, hi = -np.inf, np.inf
    i = 1
    while i < n - 1:
        i2 = min(i + _CHUNK, n - 1)
        dx = keys_f64[i:i2] - x0
        dy = np.arange(i, i2, dtype=np.float64) - y0
        slope = dy / dx
        lo_b = (dy - eps) / dx
        hi_b = (dy + eps) / dx
        # the cone *before* each point joins: shifted running bounds
        lo_pre = np.maximum(np.concatenate([[lo], np.maximum.accumulate(lo_b)[:-1]]), lo)
        hi_pre = np.minimum(np.concatenate([[hi], np.minimum.accumulate(hi_b)[:-1]]), hi)
        bad = (slope < lo_pre) | (slope > hi_pre)
        if bad.any():
            k = int(np.argmax(bad))
            knot = i + k - 1  # the previous point becomes a knot
            knots.append(knot)
            x0, y0 = keys_f64[knot], float(knot)
            lo, hi = -np.inf, np.inf
            i = knot + 1
        else:
            lo = float(np.maximum(lo_pre[-1], lo_b[-1]))
            hi = float(np.minimum(hi_pre[-1], hi_b[-1]))
            i = i2
    knots.append(n - 1)
    return np.unique(np.asarray(knots, dtype=np.int64))


def rs_knots_scan(keys_f64, eps):
    """The exact GreedySplineCorridor on the device: a bool knot mask,
    True exactly at :func:`spline_knots`'s knots.  Interior point ``i``
    (1 .. n-2) is seen from its left neighbour; a cone violation there
    makes ``i - 1`` a knot, and the endpoints always are."""
    keys, eps, _, one = _as_rows(keys_f64, eps)
    n = keys.shape[-1]
    if n <= 2:
        mask = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
    else:
        flags = chunked_corridor_scan("rs", keys, eps, n - 2)
        mask = torch.nn.functional.pad(flags, (0, 2))
        mask[:, 0] = True
        mask[:, n - 1] = True
    return mask[0] if one else mask


def _rs_merge_round(keys, kmask, eps):
    """One parity merge round over a stack's knot masks: every odd-id knot
    but the last is a removal candidate, dropped when the chord from its
    left to its right neighbour knot stays within ``eps`` over every
    element it spans: a segment max over the candidate ``kid | 1``, taken
    over the dense pair ids ``kid // 2`` (the reference's ids are the odd
    ``kid | 1``, up to ``n``)."""
    n = keys.shape[-1]
    idx = torch.arange(n, device=keys.device)
    kid, kpos = segment_ids(kmask)
    last = kid[:, n - 1:n]
    g = kid | 1
    p0 = torch.gather(kpos, -1, torch.clamp(g - 1, min=0))
    p1 = torch.gather(kpos, -1, torch.clamp(g + 1, max=n - 1))
    x0 = torch.gather(keys, -1, torch.clamp(p0, 0, n - 1))
    x1 = torch.gather(keys, -1, torch.clamp(p1, 0, n - 1))
    r0 = p0.to(torch.float64)
    r1 = p1.to(torch.float64)
    pred = r0 + (keys - x0) * (r1 - r0) / (x1 - x0)
    err = torch.abs(pred - idx.to(torch.float64))
    half = kid // 2
    ok_g = segment_max(err, half, (n + 1) // 2) <= eps  # NaN (colliding f64 keys) compares False
    drop = kmask & ((kid % 2) == 1) & (kid < last) & torch.gather(ok_g, -1, half)
    return kmask & ~drop


def rs_verified_eps(keys, kmask):
    """Measured max |chord prediction - rank| of the spline that ``kmask``
    induces (one value a row), by :func:`build_rs`'s clipped interpolation,
    so the same knots give its ``eps_eff`` measure bit for bit."""
    keys, _, _, one = _as_rows(keys, None)
    kmask = kmask.reshape(keys.shape)
    n = keys.shape[-1]
    if n <= 2:
        meas = torch.zeros(keys.shape[0], dtype=torch.float64, device=keys.device)
        return meas[0] if one else meas
    idx = torch.arange(n, device=keys.device)
    kid, kpos = segment_ids(kmask)
    last = kid[:, n - 1:n]
    j = torch.minimum(kid, last - 1)
    p0 = torch.gather(kpos, -1, j)
    p1 = torch.gather(kpos, -1, j + 1)
    x1 = torch.gather(keys, -1, torch.clamp(p0, 0, n - 1))
    x2 = torch.gather(keys, -1, torch.clamp(p1, 0, n - 1))
    t = torch.clamp((keys - x1) / torch.clamp(x2 - x1, min=1.0), 0.0, 1.0)
    pred = p0.to(torch.float64) + t * (p1 - p0).to(torch.float64)
    meas = torch.amax(torch.abs(pred - idx.to(torch.float64)), dim=-1)
    return meas[0] if one else meas


def rs_knots_fast(keys_f64, eps):
    """O(log n)-depth GreedySplineCorridor fit (``fit="fast"``): blocks of
    ``FAST_CHUNK`` points, each re-anchored at its first element (a forced
    knot), in one kernel launch; parity merge rounds that drop the block
    knots whose neighbour-to-neighbour chord stays within ``eps``; then a
    chord re-measure.  Knots are NOT :func:`spline_knots`'s.  Returns
    ``(mask, ok)`` (``ok`` a device bool a row, False when the measured
    error exceeds ``eps``); :func:`build_rs` re-derives ``eps_eff`` from
    the knots either way."""
    keys, eps, _, one = _as_rows(keys_f64, eps)
    n = keys.shape[-1]
    if n <= 2:
        mask = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
        ok = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
        return (mask[0], ok[0]) if one else (mask, ok)
    flags = blocked_corridor_scan("rs", keys, eps, n - 1, FAST_CHUNK)
    # a flag at point i marks knot i - 1: the flag's own position
    kmask = torch.nn.functional.pad(flags, (0, 1))
    kmask = kmask | (torch.arange(n, device=keys.device) % FAST_CHUNK == 0)
    kmask[:, n - 1] = True
    for _ in range(_merge_rounds(n)):
        kmask = _rs_merge_round(keys, kmask, eps[:, None])
    ok = rs_verified_eps(keys, kmask) <= eps
    return (kmask[0], ok[0]) if one else (kmask, ok)


@dataclass
class RSModel:
    eps: int
    eps_eff: int  # verified bound after the build (f64 rounding slack included)
    knot_keys: np.ndarray  # (m,) uint64
    knot_ranks: np.ndarray  # (m,) int64
    radix_table: np.ndarray  # (2^r + 1,) int64
    kmin: np.uint64
    shift: int
    r_bits: int
    n: int
    m: int
    build_time: float = 0.0
    name: str = "RS"

    def intervals(self, table, q):
        """Window of each encoded query (``table`` and ``q`` are encoded
        key tensors on one device)."""
        dev = q.device
        scalars = [torch.tensor(v, dtype=torch.int64, device=dev)
                   for v in (self.shift, self.eps_eff, self.m)]
        return search.one_table(rs_window, q, encode(self.knot_keys, dev),
                                torch.as_tensor(self.knot_ranks, device=dev),
                                torch.as_tensor(self.radix_table, device=dev), encode(self.kmin, dev),
                                *scalars, r_bits=self.r_bits, n=self.n, steps=ceil_log2(self.m))

    @property
    def max_window(self) -> int:
        return min(2 * self.eps_eff + 3, self.n)

    def predecessor(self, table, q):
        lo, hi = self.intervals(table, q)
        return search.bounded_bfs(table, q, lo, hi, max_window=self.max_window)

    def space_bytes(self) -> int:
        # knots (key 8 + rank 8) + radix table (8 per entry)
        return self.m * 16 + ((1 << self.r_bits) + 1) * 8 + 16


def build_rs(table_np: np.ndarray, eps: int = 32, r_bits: int = 12, *, knots=None) -> RSModel:
    """Single-pass RadixSpline build: knots, the radix table over the top
    ``r_bits`` of ``key - kmin``, and the verified error bound.  ``knots``
    optionally supplies the knot indices (e.g. a device fit's); the radix
    table and the bound are always derived from them."""
    sw = stopwatch()
    n = len(table_np)
    keys = table_np.astype(np.float64)
    if knots is None:
        knots = spline_knots(keys, eps)
    knots = np.asarray(knots, dtype=np.int64)
    m = len(knots)
    knot_keys = table_np[knots]
    knot_ranks = knots.astype(np.int64)

    kmin, kmax = table_np[0], table_np[-1]
    span = int(kmax - kmin)
    span_bits = max(span.bit_length(), 1)
    r_bits = min(r_bits, span_bits)
    shift = max(0, span_bits - r_bits)
    prefixes = ((knot_keys - kmin) >> np.uint64(shift)).astype(np.int64)
    rt = np.searchsorted(prefixes, np.arange((1 << r_bits) + 1), side="left").astype(np.int64)

    # verified bound over every key (linear interpolation between knots)
    seg = np.clip(np.searchsorted(knots, np.arange(n), side="right") - 1, 0, m - 2)
    x1 = keys[knots[seg]]
    x2 = keys[knots[seg + 1]]
    y1 = knots[seg].astype(np.float64)
    y2 = knots[seg + 1].astype(np.float64)
    t = np.clip((keys - x1) / np.maximum(x2 - x1, 1.0), 0.0, 1.0)
    pred = y1 + t * (y2 - y1)
    eps_eff = int(np.ceil(np.max(np.abs(pred - np.arange(n, dtype=np.float64))))) + 1

    return RSModel(
        eps=eps,
        eps_eff=max(eps_eff, 1),
        knot_keys=knot_keys,
        knot_ranks=knot_ranks,
        radix_table=rt,
        kmin=np.uint64(kmin),
        shift=shift,
        r_bits=r_bits,
        n=n,
        m=m,
        build_time=sw.elapsed,
        name=f"RS[eps={eps},r={r_bits}]",
    )
