"""Two-level RMI (counterpart of ``repro.core.rmi``).

A monotone root (linear, endpoint spline, or cubic with a monotonicity
check and a linear fallback) partitions the universe; ``b`` linear
leaves predict the rank.  Per-leaf error bounds are measured over the
leaf's rank range extended by one key on each side and leaf slopes are
clamped >= 0, so the predicted window is a guarantee.  Host numpy,
operation for operation as the reference; the query side
(:func:`rmi_window`, ``RMIModel.intervals``) runs on encoded key tensors.
:func:`rmi_leaf_fit` is the leaf stage on the device, over one table or
a stack, and :func:`assemble_rmi` makes a model of its arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.obs.timing import stopwatch

from . import search
from .atomic import poly_eval_np, poly_eval_torch, poly_fit
from .cdf import segment_max, segment_sum
from .keys import to_f64
from .search import take_fill

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

    def _leaf_of(self, u):
        return rmi_leaf(u, torch.as_tensor(self.root_coef, device=u.device), self.b, self.n)

    def intervals(self, table, q):
        """Window of each encoded query (``table`` and ``q`` are encoded
        key tensors on one device)."""
        dev = q.device
        leaves = [torch.as_tensor(a, device=dev) for a in (
            self.root_coef, self.leaf_slope, self.leaf_icept, self.leaf_eps, self.leaf_r,
            self.kmin, self.inv_span)]
        return search.one_table(rmi_window, q, *leaves, n=self.n)

    @property
    def max_window(self) -> int:
        return max(self.max_window_, 1)

    def predecessor(self, table, q):
        lo, hi = self.intervals(table, q)
        return search.bounded_bfs(table, q, lo, hi, max_window=self.max_window)

    def space_bytes(self) -> int:
        # slope + intercept (f64) + eps (i32) + rank fence (i64) per leaf, + root
        return self.b * (8 + 8 + 4 + 8) + 32 + 24


def rmi_leaf(u, root_coef, b: int, n: int):
    """Leaf of each ``u``: the root's prediction scaled to ``b`` leaves, in
    float64 (``root_coef`` broadcast against ``u``)."""
    p = torch.clamp(poly_eval_torch(root_coef, u), -4.0e15, 4.0e15)
    return torch.clamp(torch.floor(p * (b / n)).to(torch.int64), 0, b - 1)


def rmi_window(q, root_coef, leaf_slope, leaf_icept, leaf_eps, leaf_r, kmin, inv_span, *, n: int):
    """Inclusive window of each encoded query: the root picks the leaf,
    whose line at ``u`` widened by its ``eps`` is clamped into
    ``[r_l - 1, r_{l+1}]``, the range a monotone root proves (the high
    fence is ``r_{l+1}``, not ``r_{l+1} - 1``: a one-ulp difference between
    the build's and the query's root evaluation may flip the leaf of a
    boundary key, which the extended ``eps`` covers).  The leaves are a
    stack's, the queries ``(N, B)``; one model is the stack of one
    (:func:`search.one_table`)."""
    b = leaf_slope.shape[-1]
    root_coef, kmin, inv_span = root_coef[:, None], kmin[:, None], inv_span[:, None]
    u = torch.clamp((to_f64(q) - kmin) * inv_span, 0.0, 1.0)
    leaf = rmi_leaf(u, root_coef, b, n)
    p = torch.clamp(take_fill(leaf_slope, leaf) * u + take_fill(leaf_icept, leaf),
                    -4.0e15, 4.0e15)
    eps = take_fill(leaf_eps, leaf)
    lo = torch.floor(p).to(torch.int64) - eps
    hi = torch.ceil(p).to(torch.int64) + eps
    b_lo = torch.clamp(take_fill(leaf_r, leaf) - 1, min=0)
    b_hi = torch.clamp(take_fill(leaf_r, leaf + 1), max=n - 1)
    return search.clip(lo, b_lo, b_hi), search.clip(hi, b_lo, b_hi)


def rmi_leaf_fit(u, root_coef, b: int):
    """The leaf stage of :func:`build_rmi` on the device, over ``u`` (f64,
    sorted, ``(n,)`` or a stack ``(N, n)``) and a fitted monotone root
    (``(4,)`` or ``(N, 4)``): leaf assignment (``cummax`` against float
    jitter), per-leaf least squares by segment sums, and the error bounds
    over each leaf's rank range extended by one key each side.

    The segments are consecutive (the leaf ids are monotone), so every sum
    is a sorted-segment sum in element order (:func:`segment_sum`): two
    builds of one table give the same leaves on the card, and on the CPU
    the sums are ``np.bincount``'s.  Leaf floats may still differ from the
    reference's by a few ulp, but each bound is measured against this
    fit's own predictions, so windows stay guarantees and ranks exact.

    Returns ``(slopes, icepts, eps, r)`` of shapes ``(b,)`` and ``(b + 1,)``
    (a leading table axis for a stack)."""
    one = u.dim() == 1
    u = u.reshape(-1, u.shape[-1])
    root_coef = root_coef.reshape(-1, 4).to(torch.float64)
    n, dev = u.shape[-1], u.device
    ranks = torch.arange(n, dtype=torch.float64, device=dev).expand(u.shape)
    p = poly_eval_torch(root_coef[:, None, :], u)
    leaf_of = torch.clamp(torch.floor(p * (b / n)), 0, b - 1).to(torch.int64)
    seg = torch.cummax(leaf_of, dim=-1).values  # monotone against float jitter
    targets = torch.arange(b + 1, device=dev).expand(u.shape[0], b + 1).contiguous()
    r = torch.searchsorted(seg, targets, side="left")
    lengths = r[:, 1:] - r[:, :-1]
    cnt = lengths.to(torch.float64)
    su = segment_sum(u, lengths)
    sr = segment_sum(ranks, lengths)
    suu = segment_sum(u * u, lengths)
    sur = segment_sum(u * ranks, lengths)
    var = cnt * suu - su * su
    cov = cnt * sur - su * sr
    nz = (cnt > 1) & (var > 1e-30)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    slopes = torch.where(nz, torch.maximum(cov / torch.where(nz, var, 1.0), zero), 0.0)
    icepts = torch.where(nz, (sr - slopes * su) / torch.where(nz, cnt, 1.0), 0.0)
    icepts = torch.where(cnt == 1, sr, icepts)
    icepts = torch.where(cnt == 0, r[:, :-1].to(torch.float64), icepts)  # predict the range start
    # per-leaf eps over the rank range extended by one key each side
    pred = torch.gather(slopes, -1, seg) * u + torch.gather(icepts, -1, seg)
    eps_core = segment_max(torch.abs(pred - ranks), seg, b, initial=0.0)
    lo_idx = torch.clamp(r[:, :-1] - 1, 0, n - 1)
    hi_idx = torch.clamp(r[:, 1:], 0, n - 1)

    def err_at(i):
        return torch.abs(slopes * torch.gather(u, -1, i) + icepts - torch.gather(ranks, -1, i))

    eps_f = torch.maximum(eps_core, torch.maximum(err_at(lo_idx), err_at(hi_idx)))
    eps = torch.ceil(torch.clamp(eps_f, max=float(1 << 40))).to(torch.int64) + 1
    out = (slopes, icepts, eps, r)
    return tuple(a[0] for a in out) if one else out


def assemble_rmi(table_np: np.ndarray, root_type: str, root_coef: np.ndarray, kmin: np.float64,
                 inv_span: np.float64, slopes: np.ndarray, icepts: np.ndarray, eps: np.ndarray,
                 r: np.ndarray, build_time: float = 0.0) -> RMIModel:
    """An :class:`RMIModel` of leaf-fit arrays (the batched path)."""
    b = len(slopes)
    width = np.diff(r)  # leaf rank-range widths (+3: one-ulp fence slack)
    max_window = int(np.max(np.minimum(2 * eps + 3, width + 3))) if b else 1
    return RMIModel(
        root_type=root_type,
        root_coef=np.asarray(root_coef),
        b=b,
        leaf_slope=np.asarray(slopes),
        leaf_icept=np.asarray(icepts),
        leaf_eps=np.asarray(eps),
        leaf_r=np.asarray(r),
        kmin=np.float64(kmin),
        inv_span=np.float64(inv_span),
        max_eps=int(eps.max()) if b else 0,
        max_window_=max_window,
        n=len(table_np),
        build_time=build_time,
        name=f"RMI[{root_type},b={b}]",
    )


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
    sw = stopwatch()
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
        build_time=sw.elapsed,
        name=f"RMI[{root_type},b={b}]",
    )
