"""Two-level RMI (counterpart of ``repro.core.rmi``).

A monotone root (linear, endpoint spline, or cubic with a monotonicity
check and a linear fallback) partitions the universe; ``b`` linear
leaves predict the rank.  Per-leaf error bounds are measured over the
leaf's rank range extended by one key on each side and leaf slopes are
clamped >= 0, so the predicted window is a guarantee.  Host numpy,
operation for operation as the reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .atomic import poly_eval_np, poly_fit

ROOT_TYPES = ("linear", "cubic", "spline")


@dataclass
class RMIModel:
    root_type: str
    root_coef: np.ndarray  # (4,) f64, predicts rank from u
    b: int
    leaf_slope: np.ndarray  # (b,) f64 — rank per unit u
    leaf_icept: np.ndarray  # (b,) f64
    leaf_eps: np.ndarray  # (b,) int64
    leaf_r: np.ndarray  # (b+1,) int64 — first rank per leaf
    kmin: np.float64
    inv_span: np.float64
    max_eps: int
    max_window_: int
    n: int
    build_time: float = 0.0
    name: str = "RMI"

    @property
    def max_window(self) -> int:
        return max(self.max_window_, 1)

    def space_bytes(self) -> int:
        # slope + intercept (f64) + eps (i32) + rank fence (i64) per leaf, + root
        return self.b * (8 + 8 + 4 + 8) + 32 + 24


def _fit_root(u: np.ndarray, ranks: np.ndarray, root_type: str) -> np.ndarray:
    n = len(ranks)
    if root_type == "spline" or n < 8:
        coef = np.zeros(4)
        coef[1] = float(n - 1) if n > 1 else 0.0  # endpoint line through the CDF
        return coef
    if root_type == "linear":
        return poly_fit(u, ranks, 1)
    if root_type == "cubic":
        coef = poly_fit(u, ranks, 3)
        # p' is a quadratic: its minimum over [0,1] is at an endpoint or at
        # its vertex u* = -c2/(3 c3); fall back to linear if p' < 0 there
        probes = [0.0, 1.0]
        if coef[3] != 0.0:
            vertex = -coef[2] / (3.0 * coef[3])
            if 0.0 < vertex < 1.0:
                probes.append(vertex)
        probes = np.asarray(probes)
        dp = coef[1] + 2 * coef[2] * probes + 3 * coef[3] * probes**2
        if np.any(dp < 0):
            return poly_fit(u, ranks, 1)
        return coef
    raise ValueError(root_type)


def fit_root(table_np: np.ndarray, root_type: str) -> tuple:
    """Host root fit of :func:`build_rmi`: ``(root_coef, kmin, inv_span)``."""
    n = len(table_np)
    kmin, kmax = table_np[0], table_np[-1]
    span = np.float64(kmax - kmin)
    inv_span = np.float64(1.0) / span if span > 0 else np.float64(1.0)
    u = (table_np.astype(np.float64) - np.float64(kmin)) * inv_span
    ranks = np.arange(n, dtype=np.float64)
    return _fit_root(u, ranks, root_type), np.float64(kmin), inv_span


def build_rmi(table_np: np.ndarray, b: int = 1024, root_type: str = "linear") -> RMIModel:
    t0 = time.perf_counter()
    n = len(table_np)
    b = max(2, min(b, n))
    kmin, kmax = table_np[0], table_np[-1]
    span = np.float64(kmax - kmin)
    inv_span = np.float64(1.0) / span if span > 0 else np.float64(1.0)
    # identical expression to the query path (multiply by the reciprocal):
    # a 1-ulp divide/multiply mismatch can flip the leaf of a boundary key
    u = (table_np.astype(np.float64) - np.float64(kmin)) * inv_span
    ranks = np.arange(n, dtype=np.float64)

    root = _fit_root(u, ranks, root_type)
    # leaf assignment (monotone root => contiguous, non-decreasing)
    leaf_of = np.clip(np.floor(poly_eval_np(root, u) * (b / n)), 0, b - 1).astype(np.int64)
    leaf_of = np.maximum.accumulate(leaf_of)  # enforce monotone against fp jitter
    r = np.searchsorted(leaf_of, np.arange(b + 1), side="left").astype(np.int64)

    slopes = np.zeros(b, dtype=np.float64)
    icepts = np.zeros(b, dtype=np.float64)

    # per-leaf linear fits via segment sums (single pass)
    seg = leaf_of
    cnt = np.bincount(seg, minlength=b).astype(np.float64)
    su = np.bincount(seg, weights=u, minlength=b)
    sr = np.bincount(seg, weights=ranks, minlength=b)
    suu = np.bincount(seg, weights=u * u, minlength=b)
    sur = np.bincount(seg, weights=u * ranks, minlength=b)
    var = cnt * suu - su * su
    cov = cnt * sur - su * sr
    nz = (cnt > 1) & (var > 1e-30)
    slopes[nz] = np.maximum(cov[nz] / var[nz], 0.0)  # clamp >= 0 (monotone)
    icepts[nz] = (sr[nz] - slopes[nz] * su[nz]) / cnt[nz]
    one = cnt == 1
    icepts[one] = sr[one]
    empty = cnt == 0
    icepts[empty] = r[:-1][empty].astype(np.float64)  # predict the range start

    # per-leaf eps over the rank range extended by one key each side
    pred = slopes[seg] * u + icepts[seg]
    err = np.abs(pred - ranks)
    eps_core = np.zeros(b)
    np.maximum.at(eps_core, seg, err)
    lo_idx = np.clip(r[:-1] - 1, 0, n - 1)
    hi_idx = np.clip(r[1:], 0, n - 1)
    err_lo = np.abs(slopes * u[lo_idx] + icepts - ranks[lo_idx])
    err_hi = np.abs(slopes * u[hi_idx] + icepts - ranks[hi_idx])
    eps_f = np.maximum(eps_core, np.maximum(err_lo, err_hi))
    eps = np.ceil(np.minimum(eps_f, float(1 << 40))).astype(np.int64) + 1

    width = np.diff(r)  # leaf rank-range widths (+3: one-ulp fence slack)
    max_window = int(np.max(np.minimum(2 * eps + 3, width + 3))) if b else 1

    return RMIModel(
        root_type=root_type,
        root_coef=root,
        b=b,
        leaf_slope=slopes,
        leaf_icept=icepts,
        leaf_eps=eps,
        leaf_r=r,
        kmin=np.float64(kmin),
        inv_span=np.float64(inv_span),
        max_eps=int(eps.max()),
        max_window_=max_window,
        n=n,
        build_time=time.perf_counter() - t0,
        name=f"RMI[{root_type},b={b}]",
    )
