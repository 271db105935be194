"""Atomic models L / Q / C (counterpart of ``repro.core.atomic``).

One degree-1/2/3 least-squares polynomial of the key->rank curve, with
an exact error bound: the polynomial's extremes between consecutive keys
lie at the keys or at its critical points, so evaluating both bounds the
window half-width.  Host numpy, operation for operation as the reference;
the query side (:func:`atomic_window`, ``AtomicModel.intervals``) runs on
encoded key tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.obs.timing import stopwatch

from . import search
from .keys import to_f64


def poly_fit(u: np.ndarray, y: np.ndarray, degree: int) -> np.ndarray:
    """Least-squares polynomial fit, ascending coefficients, padded to 4."""
    coef_desc = np.polyfit(u, y, degree)
    out = np.zeros(4, dtype=np.float64)
    out[: degree + 1] = coef_desc[::-1]
    return out


def poly_eval_np(coef: np.ndarray, u: np.ndarray) -> np.ndarray:
    return ((coef[3] * u + coef[2]) * u + coef[1]) * u + coef[0]


def poly_eval_torch(coef: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """:func:`poly_eval_np` on tensors (the reference's ``poly_eval_jnp``):
    separate multiplies and adds, no fused multiply-add."""
    return ((coef[..., 3] * u + coef[..., 2]) * u + coef[..., 1]) * u + coef[..., 0]


def atomic_window(q, coef, kmin, inv_span, eps, *, n: int):
    """Inclusive window ``[lo, hi]`` of each encoded query: the polynomial
    at ``u`` widened by ``eps``, clipped to the table.  The leaves are a
    stack's (``(N, 4)`` coef, the rest ``(N,)``), the queries ``(N, B)``;
    one model is the stack of one (:func:`search.one_table`)."""
    coef, kmin, inv_span, eps = coef[:, None], kmin[:, None], inv_span[:, None], eps[:, None]
    u = torch.clamp((to_f64(q) - kmin) * inv_span, 0.0, 1.0)  # out-of-domain queries clamp
    p = torch.clamp(poly_eval_torch(coef, u), -4.0e15, 4.0e15)
    lo = torch.floor(p).to(torch.int64) - eps
    hi = torch.ceil(p).to(torch.int64) + eps
    return torch.clamp(lo, 0, n - 1), torch.clamp(hi, 0, n - 1)


def poly_crit_points(coef: np.ndarray) -> np.ndarray:
    """Real roots of p' (ascending coef, padded cubic) — where p can turn."""
    c1, c2, c3 = coef[1], 2.0 * coef[2], 3.0 * coef[3]
    if c3 != 0.0:
        disc = c2 * c2 - 4.0 * c3 * c1
        if disc < 0:
            return np.empty(0)
        s = np.sqrt(disc)
        return np.array([(-c2 - s) / (2 * c3), (-c2 + s) / (2 * c3)])
    if c2 != 0.0:
        return np.array([-c1 / c2])
    return np.empty(0)


def poly_exact_eps(
    coef: np.ndarray, u_keys: np.ndarray, ranks: np.ndarray, u_lo: float, u_hi: float
) -> int:
    """Exact bound on max |p(x) - pred_rank(x)| for x in [u_lo, u_hi], plus
    the rank slack of 1."""
    preds = poly_eval_np(coef, u_keys)
    eps_keys = float(np.max(np.abs(preds - ranks))) if len(ranks) else 0.0
    eps_crit = 0.0
    for uc in poly_crit_points(coef):
        if u_lo < uc < u_hi:
            j = int(np.searchsorted(u_keys, uc, side="right")) - 1
            j = min(max(j, 0), len(ranks) - 1)
            pc = float(poly_eval_np(coef, np.array([uc]))[0])
            nxt = ranks[j] + 1 if j + 1 < len(ranks) else ranks[j]
            eps_crit = max(eps_crit, abs(pc - ranks[j]), abs(pc - nxt))
    return int(np.ceil(max(eps_keys, eps_crit))) + 1


@dataclass
class AtomicModel:
    """L (degree=1) / Q (2) / C (3) regression over the whole table."""

    degree: int
    coef: np.ndarray  # (4,) f64 ascending
    kmin: np.float64
    inv_span: np.float64
    eps: int
    n: int
    build_time: float = 0.0
    name: str = ""

    def intervals(self, table, q):
        """Window of each encoded query (``table`` and ``q`` are encoded
        key tensors on one device)."""
        dev = q.device
        return search.one_table(atomic_window, q, torch.as_tensor(self.coef, device=dev),
                                torch.tensor(self.kmin, dtype=torch.float64, device=dev),
                                torch.tensor(self.inv_span, dtype=torch.float64, device=dev),
                                self.eps, n=self.n)

    @property
    def max_window(self) -> int:
        return min(2 * self.eps + 3, self.n)

    def predecessor(self, table, q):
        lo, hi = self.intervals(table, q)
        return search.bounded_bfs(table, q, lo, hi, max_window=self.max_window)

    def space_bytes(self) -> int:
        # coefficients actually used + kmin/span + eps: constant space
        return 8 * (self.degree + 1) + 16 + 8


def build_atomic(table_np: np.ndarray, degree: int = 1) -> AtomicModel:
    sw = stopwatch()
    n = len(table_np)
    kmin, kmax = table_np[0], table_np[-1]
    span = np.float64(kmax - kmin)
    inv_span = np.float64(1.0) / span if span > 0 else np.float64(1.0)
    # same expression as the query path (multiply by the reciprocal)
    u = (table_np.astype(np.float64) - np.float64(kmin)) * inv_span
    ranks = np.arange(n, dtype=np.float64)
    if n <= degree + 1:
        coef = np.zeros(4)
        coef[1] = float(n - 1) if n > 1 else 0.0
        eps = n
    else:
        coef = poly_fit(u, ranks, degree)
        eps = poly_exact_eps(coef, u, ranks, 0.0, 1.0)
    return AtomicModel(
        degree=degree,
        coef=coef,
        kmin=np.float64(kmin),
        inv_span=np.float64(inv_span),
        eps=int(min(eps, 1 << 40)),  # never clip to n: the window needs the true bound
        n=n,
        build_time=sw.elapsed,
        name={1: "L", 2: "Q", 3: "C"}[degree],
    )
