"""PGM index and the bi-criteria PGM_M (counterpart of ``repro.core.pgm``).

Build: streaming anchored-cone greedy ε-PLA (each segment anchors at its
first (key, rank) point and keeps the feasible slope cone; a new segment
starts when the cone empties), recursing over segment first-keys until
one segment remains.  ``build_pgm_bicriteria`` bisects ε for the
smallest model that fits a byte budget.  Host numpy, operation for
operation as the reference.  The query side (:func:`pgm_window`,
``PGMModel.intervals``) runs on encoded key tensors.

The device fits run on f64 key tensors, one table ``(n,)`` or a stack
``(N, n)`` (one ε, and one live count, a row): :func:`pgm_segments_scan`
(the exact greedy, one corridor-scan launch a stack, masks equal to
:func:`pla_segments`'s starts) and :func:`pgm_fit_fast` (blocks of
``FAST_CHUNK`` keys in one launch, then parity merge rounds and a
verified-ε re-measure as tensor ops), with :func:`pgm_device_slopes` and
:func:`pgm_verified_eps` over a start mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from repro_torch.obs.timing import stopwatch

from . import search
from .cdf import (
    _as_rows,
    blocked_corridor_scan,
    ceil_log2,
    chunked_corridor_scan,
    segment_count,
    segment_ids,
    segment_max,
    segment_min,
)
from .keys import encode, to_f64
from .search import KEY_FILL, take_fill

_CHUNK = 4096

#: block size of the reference's exact scan fit (its ``lax.scan`` streams
#: the table in blocks of this many keys); the kernel walks a whole row,
#: so the port's exact scans take no block size
SCAN_CHUNK = 128

#: block size of the fast fit (:func:`pgm_fit_fast`): keys are fit
#: greedily in blocks of this many, then the block boundaries are merged
FAST_CHUNK = 256


def pgm_window(q, keys, slope, rank0, off, off_r, sizes, eps, *, levels: int, n: int, steps: int):
    """Inclusive window of each encoded query over the table: the descent
    over ``levels`` (root first) of the level-concatenated segment leaves.
    At each level the current segment predicts ``r0 + slope * max(q - x0,
    0)`` in float64, clamped into ``[r0 - 1, r1 - 1]`` (segment ``s``
    covers entries ``[r0[s], r0[s+1])`` of the level below) and widened by
    ``eps + 1``; a ``steps``-trip search of that window over the next
    level's keys picks the next segment.  The leaves are a stack's
    (per-table directories, as lifted at stack time), the queries
    ``(N, B)``; one model is the stack of one (:func:`search.one_table`)."""
    eps = eps[:, None]
    qf = to_f64(q)
    seg = torch.zeros(q.shape, dtype=torch.int64, device=q.device)
    for lvl in range(levels):
        o, o_r = off[:, lvl, None], off_r[:, lvl, None]
        x0 = to_f64(take_fill(keys, o + seg, KEY_FILL))
        r0 = take_fill(rank0, o_r + seg)
        pred = r0.to(torch.float64) + take_fill(slope, o + seg) * torch.clamp(qf - x0, min=0.0)
        pred = torch.clamp(pred, -1.0, 4.0e15)  # overflow-safe int cast
        b_lo = torch.clamp(r0 - 1, min=0)
        b_hi = take_fill(rank0, o_r + seg + 1) - 1
        lo = search.clip(torch.floor(pred).to(torch.int64) - (eps + 1), b_lo, b_hi)
        hi = search.clip(torch.ceil(pred).to(torch.int64) + (eps + 1), b_lo, b_hi)
        if lvl + 1 == levels:
            return torch.clamp(lo, 0, n - 1), torch.clamp(hi, 0, n - 1)
        off_n = off[:, lvl + 1, None]
        length = torch.clamp(hi - lo + 1, min=1)
        ub = search.bounded_upper_bound(keys, q, off_n + lo, length, steps=steps)
        seg = search.clip(ub - off_n - 1, 0, sizes[:, lvl + 1, None] - 1)
    raise AssertionError("unreachable")


def pla_segments(keys_f64: np.ndarray, eps: int):
    """Anchored-cone greedy ε-PLA over (key, rank) pairs.

    Returns (starts, slopes): segment start indices (int64) and slopes
    (f64, >= 0) such that for every i in segment s,
    |rank_start[s] + slope[s] * (x_i - x_start[s]) - i| <= eps.
    """
    n = len(keys_f64)
    starts: List[int] = []
    slopes: List[float] = []
    s = 0
    while s < n:
        starts.append(s)
        x0 = keys_f64[s]
        lo, hi = 0.0, np.inf
        e = s + 1
        # grow in chunks, tracking the running cone
        while e < n:
            e2 = min(e + _CHUNK, n)
            dx = keys_f64[e:e2] - x0  # > 0: keys dedup'd
            dy = np.arange(e, e2, dtype=np.float64) - s
            hi_run = np.minimum.accumulate((dy + eps) / dx)
            lo_run = np.maximum.accumulate((dy - eps) / dx)
            hi_run = np.minimum(hi_run, hi)
            lo_run = np.maximum(lo_run, lo)
            bad = lo_run > hi_run
            if bad.any():
                k = int(np.argmax(bad))
                if k > 0:
                    lo = float(lo_run[k - 1])
                    hi = float(hi_run[k - 1])
                e = e + k
                break
            lo = float(lo_run[-1])
            hi = float(hi_run[-1])
            e = e2
        if e == s + 1:  # single-point segment
            slopes.append(max(lo, 0.0) if np.isfinite(lo) else 0.0)
            s = e
            continue
        hi_f = hi if np.isfinite(hi) else max(lo, 0.0) + 1.0
        slopes.append(max(0.5 * (max(lo, 0.0) + max(hi_f, 0.0)), 0.0))
        s = e
    return np.asarray(starts, dtype=np.int64), np.asarray(slopes, dtype=np.float64)


def pgm_segments_scan(keys_f64, eps, *, count=None):
    """The exact anchored-cone greedy ε-PLA on the device: a bool mask,
    True exactly at the segment starts :func:`pla_segments` emits (the
    kernel walks the same f64 cone, and min/max are exact).  ``count``
    restricts the fit to a live prefix (a device tensor the host never
    reads)."""
    keys, eps, count, one = _as_rows(keys_f64, eps, count)
    mask = chunked_corridor_scan("pgm", keys, eps, keys.shape[-1], count=count)
    return mask[0] if one else mask


def _pgm_merge_round(keys, ranks, mask, eps, count=None):
    """One parity merge round over a stack: every odd-id segment is
    re-tested against its even left neighbour's anchor cone over the
    union, and its boundary dropped where the merged cone is non-empty.
    Elements at or past ``count`` contribute identity bounds."""
    n = keys.shape[-1]
    idx = torch.arange(n, device=keys.device)
    seg, start = segment_ids(mask)
    pair = seg // 2
    a_pos = torch.gather(start, -1, 2 * pair)
    xa = torch.gather(keys, -1, a_pos)
    dy = ranks - a_pos.to(torch.float64)
    dx = keys - xa
    anchor = idx == a_pos
    lo_b = torch.where(anchor, float("-inf"), (dy - eps) / dx)
    hi_b = torch.where(anchor, float("inf"), (dy + eps) / dx)
    if count is not None:
        live = idx < count
        lo_b = torch.where(live, lo_b, float("-inf"))
        hi_b = torch.where(live, hi_b, float("inf"))
    n_pairs = (n + 1) // 2  # pair ids are at most (n - 1) // 2
    lo = segment_max(lo_b, pair, n_pairs)
    hi = segment_min(hi_b, pair, n_pairs)
    ok_pair = lo <= hi  # NaN bounds (colliding f64 keys) compare False: merge vetoed
    drop = mask & ((seg % 2) == 1) & torch.gather(ok_pair, -1, pair)
    return mask & ~drop


def pgm_device_slopes(keys, mask, eps, count=None):
    """:func:`segment_slopes` on the device, over a start mask: returns
    ``(slopes, start, seg)`` at capacity ``n`` (entries past the live
    segment count are unused), the start index of each id and each
    element's id.  The min/max segment reductions are exact, so a mask of
    the exact scan gives the host's slopes bit for bit."""
    keys, eps, count, one = _as_rows(keys, eps, count)
    mask = mask.reshape(keys.shape)
    n = keys.shape[-1]
    eps = eps[:, None]
    idx = torch.arange(n, device=keys.device)
    seg, start = segment_ids(mask)
    a_pos = torch.gather(start, -1, seg)
    dy = idx.to(torch.float64) - a_pos.to(torch.float64)
    dx = keys - torch.gather(keys, -1, a_pos)
    anchor = idx == a_pos
    lo_b = torch.where(anchor, float("-inf"), (dy - eps) / dx)
    hi_b = torch.where(anchor, float("inf"), (dy + eps) / dx)
    ones = torch.ones(keys.shape, dtype=torch.int64, device=keys.device)
    if count is not None:
        live = idx < count[:, None]
        lo_b = torch.where(live, lo_b, float("-inf"))
        hi_b = torch.where(live, hi_b, float("inf"))
        ones = torch.where(live, ones, 0)
    lo = segment_max(lo_b, seg, n)
    hi = segment_min(hi_b, seg, n)
    length = segment_count(ones, seg, n)
    zero = torch.zeros((), dtype=torch.float64, device=keys.device)
    hi_f = torch.where(torch.isfinite(hi), hi, torch.maximum(lo, zero) + 1.0)
    slopes = torch.maximum(0.5 * (torch.maximum(lo, zero) + torch.maximum(hi_f, zero)), zero)
    slopes = torch.where(length == 1, 0.0, slopes)
    if one:
        return slopes[0], start[0], seg[0]
    return slopes, start, seg


def pgm_verified_eps(keys, mask, eps, count=None):
    """Measured max |prediction - rank| of the PLA that ``mask`` induces
    (one value a row).  NaN propagates and compares False against any
    bound, so a degenerate fit fails ``measured <= eps``."""
    keys, eps, count, one = _as_rows(keys, eps, count)
    mask = mask.reshape(keys.shape)
    n = keys.shape[-1]
    slopes, start, seg = pgm_device_slopes(keys, mask, eps, count=count)
    a_pos = torch.gather(start, -1, seg)
    pred = a_pos.to(torch.float64) + torch.gather(slopes, -1, seg) * (
        keys - torch.gather(keys, -1, a_pos))
    idx = torch.arange(n, device=keys.device)
    err = torch.abs(pred - idx.to(torch.float64))
    if count is not None:
        err = torch.where(idx < count[:, None], err, 0.0)
    meas = torch.amax(err, dim=-1)
    return meas[0] if one else meas


def pgm_fit_fast(keys_f64, eps, *, count=None):
    """O(log n)-depth ε-PLA fit (``fit="fast"``): the greedy inside blocks
    of ``FAST_CHUNK`` keys (one kernel launch for every block of the stack,
    each block re-anchored), parity merge rounds that drop the spurious
    block boundaries, and a verified-ε re-measure.  A valid ε-PLA whose
    boundaries are NOT the greedy's.  Returns ``(mask, ok)``; ``ok`` (a
    device bool a row) is False when the measured error exceeds ``eps``
    (f64 key collisions), and callers then fall back to the exact scan."""
    keys, eps, count, one = _as_rows(keys_f64, eps, count)
    n = keys.shape[-1]
    ranks = torch.arange(n, dtype=torch.float64, device=keys.device)
    mask = blocked_corridor_scan("pgm", keys, eps, n, FAST_CHUNK, count=count)
    cnt = None if count is None else count[:, None]
    for _ in range(_merge_rounds(n)):
        mask = _pgm_merge_round(keys, ranks, mask, eps[:, None], count=cnt)
    ok = pgm_verified_eps(keys, mask, eps, count=count) <= eps
    return (mask[0], ok[0]) if one else (mask, ok)


def _merge_rounds(n: int) -> int:
    """Parity merge rounds of a fast fit over ``n`` keys: enough to merge
    all ``ceil(n / FAST_CHUNK)`` blocks into one, plus one."""
    return ceil_log2(max(-(-n // FAST_CHUNK), 2)) + 1


def segment_slopes(keys_f64: np.ndarray, starts: np.ndarray, eps) -> np.ndarray:
    """Slopes for given segment ``starts`` — bit-identical to the ones
    :func:`pla_segments` pairs with them (min/max reductions are exact)."""
    keys_f64 = np.asarray(keys_f64, dtype=np.float64)
    starts = np.asarray(starts, dtype=np.int64)
    n = len(keys_f64)
    eps = np.float64(eps)
    lens = np.diff(np.append(starts, n))
    seg_of = np.repeat(np.arange(len(starts)), lens)
    dx = keys_f64 - keys_f64[starts[seg_of]]
    dy = np.arange(n, dtype=np.float64) - starts[seg_of].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        lo_b = (dy - eps) / dx
        hi_b = (dy + eps) / dx
    lo = np.maximum.reduceat(lo_b, starts)
    hi = np.minimum.reduceat(hi_b, starts)
    hi_f = np.where(np.isfinite(hi), hi, np.maximum(lo, 0.0) + 1.0)
    slopes = np.maximum(0.5 * (np.maximum(lo, 0.0) + np.maximum(hi_f, 0.0)), 0.0)
    return np.where(lens == 1, 0.0, slopes)


@dataclass
class PGMModel:
    eps: int
    # levels stored root-first
    level_keys: list  # uint64 arrays, root..leaf level
    level_slope: list  # f64 arrays
    level_rank0: list  # int64 arrays (start rank of each segment + sentinel)
    level_sizes: list  # ints: #segments per level
    n: int
    n_segments_l0: int
    build_time: float = 0.0
    name: str = "PGM"

    def intervals(self, table, q):
        """Window of each encoded query (``table`` and ``q`` are encoded
        key tensors on one device): :func:`pgm_window` on the levels
        concatenated root first."""
        dev = q.device
        sizes = np.asarray(self.level_sizes, dtype=np.int64)
        off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        off_r = np.concatenate([[0], np.cumsum(sizes + 1)]).astype(np.int64)
        leaves = [torch.as_tensor(a, device=dev) for a in (
            np.concatenate(self.level_slope), np.concatenate(self.level_rank0), off, off_r, sizes,
            np.int64(self.eps))]
        return search.one_table(pgm_window, q, encode(np.concatenate(self.level_keys), dev),
                                *leaves, levels=len(self.level_keys), n=self.n,
                                steps=ceil_log2(2 * (self.eps + 2) + 3))

    @property
    def max_window(self) -> int:
        return min(2 * (self.eps + 2) + 3, self.n)

    def predecessor(self, table, q):
        lo, hi = self.intervals(table, q)
        return search.bounded_bfs(table, q, lo, hi, max_window=self.max_window)

    def space_bytes(self) -> int:
        # key (8) + slope (8) + rank0 (8) per segment, all levels
        return sum(self.level_sizes) * 24 + 16


def build_pgm(table_np: np.ndarray, eps: int = 64, *, l0=None) -> PGMModel:
    """Recursive PGM build: each level is the ε-PLA of the level below's
    segment first-keys, until one segment remains.  ``l0`` optionally
    supplies the bottom level's ``(starts, slopes)`` (e.g. from a device
    fit's mask and :func:`segment_slopes`); the upper levels always
    recurse on the host."""
    sw = stopwatch()
    n = len(table_np)
    eps = max(int(eps), 1)

    level_keys, level_slope, level_rank0, level_sizes = [], [], [], []
    cur_keys_u64 = table_np
    cur_keys = table_np.astype(np.float64)
    while True:
        if l0 is not None:
            starts, slopes = l0
            l0 = None
        else:
            starts, slopes = pla_segments(cur_keys, eps)
        # rank0 with sentinel: segment s covers [rank0[s], rank0[s+1])
        rank0 = np.concatenate([starts, [len(cur_keys)]]).astype(np.int64)
        level_keys.append(cur_keys_u64[starts])
        level_slope.append(slopes)
        level_rank0.append(rank0)
        level_sizes.append(len(starts))
        if len(starts) <= 1:
            break
        cur_keys_u64 = cur_keys_u64[starts]
        cur_keys = cur_keys[starts]

    # root-first ordering
    level_keys.reverse()
    level_slope.reverse()
    level_rank0.reverse()
    level_sizes.reverse()
    return PGMModel(
        eps=eps,
        level_keys=level_keys,
        level_slope=level_slope,
        level_rank0=level_rank0,
        level_sizes=level_sizes,
        n=n,
        n_segments_l0=level_sizes[-1],
        build_time=sw.elapsed,
        name=f"PGM[eps={eps}]",
    )


# The reference sizes the bi-criteria lower bound by the TPU gather
# granularity (one 64-key x 8 B row = 512 B) in place of the paper's
# 64 B cache line; parity with the reference keeps that value.
TPU_CLS_BYTES = 512
KEY_BYTES = 8

#: bisection depth of the bi-criteria search
BICRITERIA_MAX_ITERS = 16


def bicriteria_eps_bounds(n: int, a: float = 1.0, cls_bytes: int = TPU_CLS_BYTES) -> tuple:
    """The bi-criteria search range [ε_m, ε_M] for a table of ``n`` keys
    (paper: ε_m = a · 2 · cls/size)."""
    eps_m = max(1, int(a * 2 * (cls_bytes / KEY_BYTES)))
    return eps_m, max(eps_m + 1, n // 2)


def build_pgm_bicriteria(
    table_np: np.ndarray,
    space_budget_bytes: int,
    a: float = 1.0,
    cls_bytes: int = TPU_CLS_BYTES,
    max_iters: int = BICRITERIA_MAX_ITERS,
) -> PGMModel:
    """Bi-criteria PGM_M_a: smallest ε whose model fits the budget."""
    eps_m, eps_M = bicriteria_eps_bounds(len(table_np), a, cls_bytes)
    best = None
    lo, hi = eps_m, eps_M
    for _ in range(max_iters):
        mid = (lo + hi) // 2
        m = build_pgm(table_np, eps=mid)
        if m.space_bytes() <= space_budget_bytes:
            best = m if best is None or m.eps < best.eps else best
            hi = mid - 1  # try a smaller eps (bigger model)
        else:
            lo = mid + 1
        if lo > hi:
            break
    if best is None:
        best = build_pgm(table_np, eps=eps_M)
    best.name = f"PGM_M_{a}[eps={best.eps}]"
    return best
