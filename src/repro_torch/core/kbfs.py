"""KO — the Learned k-ary Search Model (counterpart of ``repro.core.kbfs``).

Partition the table into ``k`` equal-rank segments, fit L, Q and C per
segment and keep the one with the smallest exact error bound.  Constant
space; host numpy, operation for operation as the reference.  The query
side (:func:`ko_window`, ``KOModel.intervals``) runs on encoded key
tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.obs.timing import stopwatch

from . import search
from .atomic import poly_eval_torch, poly_exact_eps, poly_fit
from .keys import encode, to_f64
from .search import take_fill


def ko_window(q, fences, coef, kmin_seg, inv_span_seg, eps, seg_start):
    """Inclusive window of each encoded query: the sequential fence scan
    picks the segment ``s`` (k-1 compares), whose polynomial at ``u``
    widened by its ``eps`` is clamped into the range the fences prove,
    ``[seg_start[s] - 1, seg_start[s+1] - 1]``.  The leaves are a stack's,
    the queries ``(N, B)``; one model is the stack of one
    (:func:`search.one_table`)."""
    s = (q[..., None] >= fences[:, None, :]).to(torch.int64).sum(-1)
    coef = torch.stack([take_fill(coef[..., j], s) for j in range(4)], -1)
    u = torch.clamp((to_f64(q) - take_fill(kmin_seg, s)) * take_fill(inv_span_seg, s), 0.0, 1.0)
    p = torch.clamp(poly_eval_torch(coef, u), -4.0e15, 4.0e15)
    e = take_fill(eps, s)
    lo = torch.floor(p).to(torch.int64) - e
    hi = torch.ceil(p).to(torch.int64) + e
    b_lo = torch.clamp(take_fill(seg_start, s) - 1, min=0)
    b_hi = take_fill(seg_start, s + 1) - 1
    return search.clip(lo, b_lo, b_hi), search.clip(hi, b_lo, b_hi)


@dataclass
class KOModel:
    k: int
    fences: np.ndarray  # (k-1,) uint64 — first key of segments 1..k-1
    coef: np.ndarray  # (k, 4) f64 ascending, per segment
    kmin_seg: np.ndarray  # (k,) f64
    inv_span_seg: np.ndarray  # (k,) f64
    eps: np.ndarray  # (k,) int64
    seg_start: np.ndarray  # (k+1,) int64 rank fences
    max_eps: int
    max_width: int
    n: int
    build_time: float = 0.0
    name: str = "KO"

    def intervals(self, table, q):
        """Window of each encoded query (``table`` and ``q`` are encoded
        key tensors on one device)."""
        dev = q.device
        leaves = [torch.as_tensor(a, device=dev)
                  for a in (self.coef, self.kmin_seg, self.inv_span_seg, self.eps, self.seg_start)]
        return search.one_table(ko_window, q, encode(self.fences, dev), *leaves)

    @property
    def max_window(self) -> int:
        return min(2 * self.max_eps + 3, self.max_width + 2, self.n)

    def predecessor(self, table, q, *, branchy: bool = False):
        lo, hi = self.intervals(table, q)
        if branchy:  # KO-BBS epilogue
            return _bounded_bbs(table, q, lo, hi)
        return search.bounded_bfs(table, q, lo, hi, max_window=self.max_window)

    def space_bytes(self) -> int:
        # fences + coeffs + rescale + eps per segment: O(k) = constant
        return self.k * (8 + 32 + 16 + 4) + 8


def _bounded_bbs(table, q, lo, hi):
    """Branchy bounded epilogue (for KO-BBS) — the shared one in search."""
    return search.bounded_bbs_branchy(table, q, lo, hi)


def build_ko(table_np: np.ndarray, k: int = 15) -> KOModel:
    """Fit L/Q/C per segment, keep the best (smallest exact eps)."""
    sw = stopwatch()
    n = len(table_np)
    k = max(1, min(k, n))
    seg_start = (np.arange(k + 1, dtype=np.int64) * n) // k
    fences = table_np[seg_start[1:k]]

    coefs = np.zeros((k, 4), dtype=np.float64)
    kmins = np.zeros(k, dtype=np.float64)
    inv_spans = np.ones(k, dtype=np.float64)
    epss = np.zeros(k, dtype=np.int64)

    for s in range(k):
        a, b = int(seg_start[s]), int(seg_start[s + 1])
        # extended range for the boundary-safe error bound
        ea, eb = max(a - 1, 0), min(b + 1, n)
        keys = table_np[ea:eb]
        ranks = np.arange(ea, eb, dtype=np.float64)
        kmin, kmax = table_np[a], table_np[min(b, n - 1) if b < n else n - 1]
        span = np.float64(kmax - kmin)
        inv = 1.0 / span if span > 0 else 1.0
        u = (keys.astype(np.float64) - np.float64(kmin)) * inv
        best = None
        if b - a < 8:
            coef = np.zeros(4)
            coef[0] = float(a)
            best = (b - a + 2, coef)
        else:
            for deg in (1, 2, 3):
                coef = poly_fit(u, ranks, deg)
                eps = poly_exact_eps(coef, u, ranks, float(u[0]), float(u[-1]))
                if best is None or eps < best[0]:
                    best = (eps, coef)
        epss[s] = min(best[0], 1 << 40)
        coefs[s] = best[1]
        kmins[s] = np.float64(kmin)
        inv_spans[s] = inv

    return KOModel(
        k=k,
        fences=fences,
        coef=coefs,
        kmin_seg=kmins,
        inv_span_seg=inv_spans,
        eps=epss,
        seg_start=seg_start,
        max_eps=int(epss.max()),
        max_width=int(np.max(np.diff(seg_start))),
        n=n,
        build_time=sw.elapsed,
        name=f"{k}O",
    )
