"""RadixSpline (counterpart of ``repro.core.radix_spline``).

GreedySplineCorridor: knots are actual (key, rank) points; a candidate
point is accepted while the slope from the current anchor stays inside
the corridor cone; on violation the previous point becomes a knot and the
cone restarts.  A radix table over the top ``r`` bits of ``key - kmin``
narrows the knot search.  The error bound is re-measured over every key
after the build, so the reported window is a guarantee under f64
rounding.  Host numpy, operation for operation as the reference; the
device scan fits wait for a later slice.  The query side
(:func:`rs_window`, ``RSModel.intervals``) runs on encoded key tensors.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from . import search
from .cdf import ceil_log2
from .keys import encode, to_f64
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


def build_rs(table_np: np.ndarray, eps: int = 32, r_bits: int = 12) -> RSModel:
    """Single-pass RadixSpline build: knots, the radix table over the top
    ``r_bits`` of ``key - kmin``, and the verified error bound."""
    t0 = time.perf_counter()
    n = len(table_np)
    keys = table_np.astype(np.float64)
    knots = spline_knots(keys, eps)
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
        build_time=time.perf_counter() - t0,
        name=f"RS[eps={eps},r={r_bits}]",
    )
