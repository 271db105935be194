"""Fused RadixSpline lookup — the kernel backend of the RS kind (CUDA
source: ``csrc/rs_search.cu``).

Replaces ``repro/kernels/rs_search.py:fused_rs_search_pallas`` and
``batched_rs_search_pallas``.  Per encoded query, the kernel first
computes what the TPU kernel took from outside: ``u``, the f32 CDF
coordinate, from the index's f64 ``rk_kmin``/``rk_inv_span`` exactly as
:func:`repro_torch.core.keys.unit_f32` computes it, and the radix prefix
``min((max(q, kmin) - kmin) >> shift, 2^r_bits - 1)`` as an *unsigned*
shift of the 64-bit difference (:func:`radix_prefix` is the twin's).
Then three dependent stages: the radix table at the prefix bounds the
knot range; an upper-bound search over the knot keys finds the
enclosing knot ``j``; the f32 re-anchored spline predicts
``y1 + slope_j * max(u - u0_j, 0)``, whose floor and ceil, clamped into
the table and widened by ε, bound a search over the table.  Both
searches stop once a query's window is one key wide, ``ksteps`` and
``steps`` only the caps.  The arithmetic is the reference's on the
``rk_*`` re-encoded leaves: no fused multiply-add, every float clamped to
±1e9 before its int32 cast.  Every gather index is clamped into its
array (the prefix so that ``radix[p + 1]`` exists, ``j`` into the valid
knots), where the reference's ``jnp.take`` would fill or wrap.  The knot
ranks, radix table and ``m_valid`` are read as the index holds them,
int64, and narrowed in the kernel.

Bound on the H100: the dependent loads — the radix table and knots are
small and shared by every query, but the table search gathers from a
window at a random place in a table that, at 2^24 keys, lives in HBM.
Each query makes its own window's trips in both searches, and the lookup
pays for no prefix or ``u`` pass and no int32 copy of a leaf.
"""

from __future__ import annotations

import torch

from repro_torch.core.keys import unit_f32

from . import cuda_lib
from .pgm_search import _bounded_ub_early
from .ref import rows_with_probes

#: kernel launches (CUDA path only); reset by callers that count them
LAUNCHES = 0
#: launches of the batched kernel (CUDA path only)
BATCHED_LAUNCHES = 0

_INT64_MAX = (1 << 63) - 1


def radix_prefix(q: torch.Tensor, kmin: torch.Tensor, shift: torch.Tensor, r_bits: int):
    """The radix prefix ``min((max(q, kmin) - kmin) >> shift, 2^r - 1)`` of
    each encoded query, as the reference computes it on uint64 (int32).

    ``kmin`` is the encoded smallest key and ``shift`` the index's shift
    leaf (both broadcast against ``q``).  The int64 difference of two
    encoded keys is the unsigned difference mod 2^64; its top bit is set
    when the key span reaches 2^63, where torch's arithmetic ``>>`` would
    sign-extend.  So a shift of at least 1 goes as a logical shift by 1
    (masking the sign bit) then an arithmetic shift by ``shift - 1`` of a
    non-negative value (by at most 63, so a shift of 64 or more gives 0,
    as a logical shift would); with shift 0 a "negative" difference is a
    value of 2^63 or more, which clamps to the top prefix."""
    qc = torch.maximum(q, kmin)
    d = qc - kmin  # the unsigned difference, mod 2^64
    logical = ((d >> 1) & _INT64_MAX) >> torch.clamp(shift - 1, min=0, max=63)
    p = torch.where(shift > 0, logical, d)
    top = (1 << r_bits) - 1
    p = torch.where(p < 0, top, torch.clamp(p, max=top))
    return p.to(torch.int32)


def _rs_window_body(u, q, prefix, knots, u0_a, slope_a, rank_a, radix, m_valid, eps, *, n: int,
                    ksteps: int):
    """Stages 1–2 of the kernel on tensors: the knot range from the radix
    table, the knot search, the f32 spline and the ε-window ``[lo, hi]``
    (int32) over the table.  ``rank_a``, ``radix`` and the one-element
    ``m_valid`` are int64, ``eps`` one-element int32."""
    # --- stage 1: the radix table bounds the knot range ---
    p = torch.clamp(prefix, 0, radix.numel() - 2)
    lo_k = torch.clamp(radix[p].to(torch.int32) - 1, min=0)
    hi_k = radix[p + 1].to(torch.int32)
    length = torch.clamp(hi_k - lo_k, min=1)

    # --- stage 2: exact knot search + f32 interpolation from knot j ---
    mv = torch.clamp(m_valid[0], max=knots.numel()).to(torch.int32)
    ub = _bounded_ub_early(knots, q, lo_k, length, steps=ksteps)
    j = torch.minimum(torch.clamp(ub - 1, min=0), torch.clamp(mv - 2, min=0))
    y1 = rank_a[j].to(torch.int32).to(torch.float32)
    pred = y1 + slope_a[j] * torch.clamp(u - u0_a[j], min=0.0)
    pred = torch.clamp(pred, -1.0e9, 1.0e9)
    # clamp the predicted centre into the table before widening
    p_lo = torch.clamp(torch.floor(pred).to(torch.int32), 0, n - 1)
    p_hi = torch.clamp(torch.ceil(pred).to(torch.int32), 0, n - 1)
    return torch.clamp(p_lo - eps[0], 0, n - 1), torch.clamp(p_hi + eps[0], 0, n - 1)


def _rs_body(u, q, prefix, t, knots, u0_a, slope_a, rank_a, radix, m_valid, eps, *, n: int,
             ksteps: int, steps: int, probes=None):
    """The kernel's arithmetic on tensors, from the f32 ``u`` and the
    prefix on (int32 predecessor ranks): :func:`_rs_window_body`, then
    stage 3, the ε-window search over the table.  ``probes``, when a
    list, receives every *table* index gathered, the trips each query
    takes."""
    lo, hi = _rs_window_body(u, q, prefix, knots, u0_a, slope_a, rank_a, radix, m_valid, eps, n=n,
                             ksteps=ksteps)
    return _bounded_ub_early(t, q, lo, hi - lo + 1, steps=steps, probes=probes) - 1


def rs_search_plain(queries, table, kmin, shift, rk_kmin, rk_inv_span, knots, u0, slope, ranks,
                    radix, m_valid, eps, *, r_bits: int, ksteps: int, steps: int, probes=None):
    """The twin on the wrapper's operands, on any device: ``u`` by
    :func:`unit_f32` and the prefix by :func:`radix_prefix` (the kernel's
    first step), then :func:`_rs_body`."""
    u = unit_f32(queries, rk_kmin, rk_inv_span)
    prefix = radix_prefix(queries, kmin, shift, r_bits)
    return _rs_body(u, queries, prefix, table, knots, u0, slope, ranks, radix, m_valid, eps,
                    n=table.numel(), ksteps=ksteps, steps=steps, probes=probes)


def _check_sizes(n: int, mk: int, rn: int, r_bits: int, what: str) -> int:
    """Raise on sizes the kernels do not take; the prefix's top value."""
    if n == 0 or n >= 2**31 or mk == 0 or mk >= 2**31 or rn < 2 or not 0 <= r_bits <= 30:
        raise ValueError(f"need 1 .. 2**31-1 {what}, >= 1 knot, >= 2 radix entries and r_bits "
                         f"in [0, 30], got n={n}, knots={mk}, radix={rn}, r_bits={r_bits}")
    return min((1 << r_bits) - 1, rn - 2)


def rs_search(queries, table, kmin, shift, rk_kmin, rk_inv_span, knots, u0, slope, ranks, radix,
              m_valid, eps, *, r_bits: int, ksteps: int, steps: int):
    """Predecessor rank (int32) of each encoded query through the fused
    RadixSpline kernel.  ``kmin`` (the encoded smallest key) and ``shift``
    are the index's one-element int64 leaves, ``rk_kmin``/``rk_inv_span``
    its one-element f64 ``rk_*`` leaves; ``knots`` the encoded knot keys,
    ``u0``/``slope`` the ``rk_*`` f32 leaves, ``ranks`` and ``radix`` the
    int64 knot ranks and radix table, ``m_valid`` a one-element int64 and
    ``eps`` a one-element int32 tensor.  CPU tensors take the plain twin;
    CUDA tensors launch the kernel."""
    dev = queries.device
    nq, n, mk, rn = queries.numel(), table.numel(), knots.numel(), radix.numel()
    cuda_lib.require(queries, "queries", torch.int64, dev)
    cuda_lib.require(table, "table", torch.int64, dev)
    cuda_lib.require(kmin, "kmin", torch.int64, dev, 1)
    cuda_lib.require(shift, "shift", torch.int64, dev, 1)
    cuda_lib.require(rk_kmin, "rk_kmin", torch.float64, dev, 1)
    cuda_lib.require(rk_inv_span, "rk_inv_span", torch.float64, dev, 1)
    cuda_lib.require(knots, "knots", torch.int64, dev)
    for name, arr in (("u0", u0), ("slope", slope)):
        cuda_lib.require(arr, name, torch.float32, dev, mk)
    cuda_lib.require(ranks, "ranks", torch.int64, dev, mk)
    cuda_lib.require(radix, "radix", torch.int64, dev)
    cuda_lib.require(m_valid, "m_valid", torch.int64, dev, 1)
    cuda_lib.require(eps, "eps", torch.int32, dev, 1)
    top = _check_sizes(n, mk, rn, r_bits, "table keys")
    if dev.type == "cpu":
        return rs_search_plain(queries, table, kmin, shift, rk_kmin, rk_inv_span, knots, u0, slope,
                               ranks, radix, m_valid, eps, r_bits=r_bits, ksteps=ksteps,
                               steps=steps)
    if dev.type != "cuda":
        raise ValueError(f"rs_search runs on cuda or cpu tensors, not {dev}")
    out = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    if nq == 0:
        return out
    cuda_lib.launch(
        "rs_search_launch", dev, queries.data_ptr(), nq, kmin.data_ptr(), shift.data_ptr(),
        rk_kmin.data_ptr(), rk_inv_span.data_ptr(), table.data_ptr(), n, knots.data_ptr(),
        u0.data_ptr(), slope.data_ptr(), ranks.data_ptr(), mk, radix.data_ptr(), rn, top,
        m_valid.data_ptr(), eps.data_ptr(), ksteps, steps, out.data_ptr(),
    )
    global LAUNCHES
    LAUNCHES += 1
    return out


def _batched_rs_body(u, q, prefix, tables, knots, u0_a, slope_a, rank_a, radix, m_valid, eps, *,
                     n: int, ksteps: int, steps: int, probes=None):
    """The batched kernel's arithmetic: :func:`_rs_body` on each table row
    with that row of ``u``, the prefix and every stacked leaf
    (``m_valid``/``eps`` hold one value a table)."""
    return rows_with_probes(
        tables, probes,
        lambda t, p: _rs_body(u[t], q[t], prefix[t], tables[t], knots[t], u0_a[t], slope_a[t],
                              rank_a[t], radix[t], m_valid[t:t + 1], eps[t:t + 1], n=n,
                              ksteps=ksteps, steps=steps, probes=p),
    )


def batched_rs_search_plain(queries, tables, kmin, shift, rk_kmin, rk_inv_span, knots, u0, slope,
                            ranks, radix, m_valid, eps, *, r_bits: int, ksteps: int, steps: int,
                            probes=None):
    """The batched twin on the wrapper's operands, on any device: ``u`` and
    the prefix of row ``t`` from table ``t``'s leaves, then
    :func:`_batched_rs_body`."""
    u = unit_f32(queries, rk_kmin[:, None], rk_inv_span[:, None])
    prefix = radix_prefix(queries, kmin[:, None], shift[:, None], r_bits)
    return _batched_rs_body(u, queries, prefix, tables, knots, u0, slope, ranks, radix, m_valid,
                            eps, n=tables.shape[1], ksteps=ksteps, steps=steps, probes=probes)


def batched_rs_search(queries, tables, kmin, shift, rk_kmin, rk_inv_span, knots, u0, slope, ranks,
                      radix, m_valid, eps, *, r_bits: int, ksteps: int, steps: int):
    """Predecessor ranks ``(n_tables, B)`` (int32) through the batched
    fused RadixSpline kernel, one launch for every table: row ``t`` of
    ``queries`` against row ``t`` of the ``(n_tables, n)`` ``tables``, of
    the stacked knot leaves and radix tables, and element ``t`` of the
    ``(n_tables,)`` ``kmin``/``shift``/``m_valid`` (int64),
    ``rk_kmin``/``rk_inv_span`` (f64) and ``eps`` (int32).  ``r_bits``
    (the radix row length) is common to the tables, and
    ``ksteps``/``steps`` cap the widest.  ``queries`` may be one ``(B,)``
    batch ``expand``-ed to every table.  CPU tensors take the plain twin;
    CUDA tensors launch the kernel."""
    dev = queries.device
    nt = tables.shape[0] if tables.dim() == 2 else -1
    cuda_lib.require_rows(tables, "tables", torch.int64, dev, nt)
    q_stride = cuda_lib.query_rows(queries, nt, dev)
    n, nq, mk, rn = tables.shape[1], queries.shape[1], knots.shape[-1], radix.shape[-1]
    for name, arr, dtype in (("kmin", kmin, torch.int64), ("shift", shift, torch.int64),
                             ("rk_kmin", rk_kmin, torch.float64),
                             ("rk_inv_span", rk_inv_span, torch.float64),
                             ("m_valid", m_valid, torch.int64), ("eps", eps, torch.int32)):
        cuda_lib.require(arr, name, dtype, dev, nt)
    cuda_lib.require_rows(knots, "knots", torch.int64, dev, nt)
    for name, arr in (("u0", u0), ("slope", slope)):
        cuda_lib.require_rows(arr, name, torch.float32, dev, nt, mk)
    cuda_lib.require_rows(ranks, "ranks", torch.int64, dev, nt, mk)
    cuda_lib.require_rows(radix, "radix", torch.int64, dev, nt)
    top = _check_sizes(n, mk, rn, r_bits, "keys a table")
    if dev.type == "cpu":
        return batched_rs_search_plain(queries, tables, kmin, shift, rk_kmin, rk_inv_span, knots,
                                       u0, slope, ranks, radix, m_valid, eps, r_bits=r_bits,
                                       ksteps=ksteps, steps=steps)
    if dev.type != "cuda":
        raise ValueError(f"batched_rs_search runs on cuda or cpu tensors, not {dev}")
    out = torch.empty((nt, nq), dtype=torch.int32, device=dev)
    if nq == 0 or nt == 0:
        return out
    cuda_lib.launch(
        "batched_rs_search_launch", dev, queries.data_ptr(), q_stride, nq, nt, kmin.data_ptr(),
        shift.data_ptr(), rk_kmin.data_ptr(), rk_inv_span.data_ptr(), tables.data_ptr(), n,
        knots.data_ptr(), u0.data_ptr(), slope.data_ptr(), ranks.data_ptr(), mk, radix.data_ptr(),
        rn, top, m_valid.data_ptr(), eps.data_ptr(), ksteps, steps, out.data_ptr(),
    )
    global BATCHED_LAUNCHES
    BATCHED_LAUNCHES += 1
    return out
