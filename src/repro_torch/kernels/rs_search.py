"""Fused RadixSpline lookup — the kernel backend of the RS kind (CUDA
source: ``csrc/rs_search.cu``).

Replaces ``repro/kernels/rs_search.py:fused_rs_search_pallas`` and
``batched_rs_search_pallas``.  Per query, three dependent stages: the
radix table at the query's prefix bounds the knot range; a search of
``ksteps`` trips over the knot keys finds the enclosing knot ``j``; the
f32 re-anchored spline predicts ``y1 + slope_j * max(u - u0_j, 0)``,
whose floor and ceil, clamped into the table and widened by ε, bound a
search of ``steps`` trips over the table.  The arithmetic is the
reference's on the ``rk_*`` re-encoded leaves: no fused multiply-add,
every float clamped to ±1e9 before its int32 cast.  Every gather index
is clamped into its array (the prefix so that ``radix[p + 1]`` exists,
``j`` into the valid knots), where the reference's ``jnp.take`` would
fill or wrap.

The prefix and ``u`` are query-side work computed outside the kernel,
as the reference's dispatch does: :func:`radix_prefix` is an *unsigned*
shift of the 64-bit difference ``max(q, kmin) - kmin``, which on the
sign-flipped int64 keys needs the sign-extended bits of torch's
arithmetic ``>>`` masked off.

Bound on the H100: bytes — the radix table and knots are small and
shared by every query, but the last stage is dependent gathers into a
table that, at 2^24 keys, lives in HBM.  This first design does nothing
about that (one thread per query, all operands in global memory).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .pgm_search import _bounded_ub
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
    non-negative value; with shift 0 a "negative" difference is a value of
    2^63 or more, which clamps to the top prefix."""
    qc = torch.maximum(q, kmin)
    d = qc - kmin  # the unsigned difference, mod 2^64
    logical = ((d >> 1) & _INT64_MAX) >> torch.clamp(shift - 1, min=0)
    p = torch.where(shift > 0, logical, d)
    top = (1 << r_bits) - 1
    p = torch.where(p < 0, top, torch.clamp(p, max=top))
    return p.to(torch.int32)


def _rs_body(u, q, prefix, t, knots, u0_a, slope_a, rank_a, radix, m_valid, eps, *, n: int,
             ksteps: int, steps: int, probes=None):
    """The kernel's arithmetic on tensors (int32 predecessor ranks).
    ``m_valid`` and ``eps`` are one-element int32 tensors; ``probes``, when
    a list, receives every *table* index gathered."""
    # --- stage 1: the radix table bounds the knot range ---
    p = torch.clamp(prefix, 0, radix.numel() - 2)
    lo_k = torch.clamp(radix[p] - 1, min=0)
    hi_k = radix[p + 1]
    length = torch.clamp(hi_k - lo_k, min=1)

    # --- stage 2: exact knot search + f32 interpolation from knot j ---
    mv = torch.clamp(m_valid[0], max=knots.numel())
    ub = _bounded_ub(knots, q, lo_k, length, steps=ksteps)
    j = torch.minimum(torch.clamp(ub - 1, min=0), torch.clamp(mv - 2, min=0))
    y1 = rank_a[j].to(torch.float32)
    pred = y1 + slope_a[j] * torch.clamp(u - u0_a[j], min=0.0)
    pred = torch.clamp(pred, -1.0e9, 1.0e9)
    # clamp the predicted centre into the table before widening
    p_lo = torch.clamp(torch.floor(pred).to(torch.int32), 0, n - 1)
    p_hi = torch.clamp(torch.ceil(pred).to(torch.int32), 0, n - 1)
    lo = torch.clamp(p_lo - eps[0], 0, n - 1)
    hi = torch.clamp(p_hi + eps[0], 0, n - 1)

    # --- stage 3: the ε-window search over the table ---
    return _bounded_ub(t, q, lo, hi - lo + 1, steps=steps, probes=probes) - 1


def rs_search_plain(u, queries, prefix, table, knots, u0, slope, ranks, radix, m_valid, eps, *,
                    ksteps: int, steps: int, probes=None):
    """The twin on the wrapper's operands, on any device."""
    return _rs_body(u, queries, prefix, table, knots, u0, slope, ranks, radix, m_valid, eps,
                    n=table.numel(), ksteps=ksteps, steps=steps, probes=probes)


def rs_search(u, queries, prefix, table, knots, u0, slope, ranks, radix, m_valid, eps, *,
              ksteps: int, steps: int):
    """Predecessor rank (int32) of each encoded query through the fused
    RadixSpline kernel.  ``u`` is the f32 CDF coordinate of each query and
    ``prefix`` its radix prefix (:func:`radix_prefix`); ``knots`` the
    encoded knot keys, ``u0``/``slope`` the index's ``rk_*`` leaves,
    ``ranks`` and ``radix`` its knot ranks and radix table as int32, and
    ``m_valid``/``eps`` one-element int32 tensors.  CPU tensors take the
    plain twin; CUDA tensors launch the kernel."""
    dev = queries.device
    nq, n, mk, rn = queries.numel(), table.numel(), knots.numel(), radix.numel()
    cuda_lib.require(u, "u", torch.float32, dev, nq)
    cuda_lib.require(queries, "queries", torch.int64, dev)
    cuda_lib.require(prefix, "prefix", torch.int32, dev, nq)
    cuda_lib.require(table, "table", torch.int64, dev)
    cuda_lib.require(knots, "knots", torch.int64, dev)
    for name, arr in (("u0", u0), ("slope", slope)):
        cuda_lib.require(arr, name, torch.float32, dev, mk)
    cuda_lib.require(ranks, "ranks", torch.int32, dev, mk)
    cuda_lib.require(radix, "radix", torch.int32, dev)
    cuda_lib.require(m_valid, "m_valid", torch.int32, dev, 1)
    cuda_lib.require(eps, "eps", torch.int32, dev, 1)
    if n == 0 or n >= 2**31 or mk == 0 or rn < 2:
        raise ValueError(f"need 1 .. 2**31-1 table keys, >= 1 knot and >= 2 radix entries, "
                         f"got n={n}, knots={mk}, radix={rn}")
    if dev.type == "cpu":
        return rs_search_plain(u, queries, prefix, table, knots, u0, slope, ranks, radix,
                               m_valid, eps, ksteps=ksteps, steps=steps)
    if dev.type != "cuda":
        raise ValueError(f"rs_search runs on cuda or cpu tensors, not {dev}")
    out = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    if nq == 0:
        return out
    cuda_lib.launch(
        "rs_search_launch", dev, u.data_ptr(), queries.data_ptr(), prefix.data_ptr(), nq,
        table.data_ptr(), n, knots.data_ptr(), u0.data_ptr(), slope.data_ptr(), ranks.data_ptr(),
        mk, radix.data_ptr(), rn, m_valid.data_ptr(), eps.data_ptr(), ksteps, steps,
        out.data_ptr(),
    )
    global LAUNCHES
    LAUNCHES += 1
    return out


def _batched_rs_body(u, q, prefix, tables, knots, u0_a, slope_a, rank_a, radix, m_valid, eps, *,
                     n: int, ksteps: int, steps: int, probes=None):
    """The batched kernel's arithmetic: :func:`_rs_body` on each table row
    with that row of every stacked leaf (``m_valid``/``eps`` hold one value
    a table)."""
    return rows_with_probes(
        tables, probes,
        lambda t, p: _rs_body(u[t], q[t], prefix[t], tables[t], knots[t], u0_a[t], slope_a[t],
                              rank_a[t], radix[t], m_valid[t:t + 1], eps[t:t + 1], n=n,
                              ksteps=ksteps, steps=steps, probes=p),
    )


def batched_rs_search_plain(u, queries, prefix, tables, knots, u0, slope, ranks, radix, m_valid,
                            eps, *, ksteps: int, steps: int, probes=None):
    """The batched twin on the wrapper's operands, on any device."""
    return _batched_rs_body(u, queries, prefix, tables, knots, u0, slope, ranks, radix, m_valid,
                            eps, n=tables.shape[1], ksteps=ksteps, steps=steps, probes=probes)


def batched_rs_search(u, queries, prefix, tables, knots, u0, slope, ranks, radix, m_valid, eps, *,
                      ksteps: int, steps: int):
    """Predecessor ranks ``(n_tables, B)`` (int32) through the batched
    fused RadixSpline kernel, one launch for every table: row ``t`` of
    ``u``, ``queries`` and ``prefix`` against row ``t`` of the
    ``(n_tables, n)`` ``tables`` and of the stacked knot leaves and radix
    tables, with ``m_valid``/``eps`` ``(n_tables,)`` int32 tensors.
    ``r_bits`` (the radix row length) is common to the tables, and
    ``ksteps``/``steps`` cover the widest.  ``queries`` may be one
    ``(B,)`` batch ``expand``-ed to every table.  CPU tensors take the
    plain twin; CUDA tensors launch the kernel."""
    dev = queries.device
    nt = tables.shape[0] if tables.dim() == 2 else -1
    cuda_lib.require_rows(tables, "tables", torch.int64, dev, nt)
    q_stride = cuda_lib.query_rows(queries, nt, dev)
    n, nq, mk, rn = tables.shape[1], queries.shape[1], knots.shape[-1], radix.shape[-1]
    cuda_lib.require_rows(u, "u", torch.float32, dev, nt, nq)
    cuda_lib.require_rows(prefix, "prefix", torch.int32, dev, nt, nq)
    cuda_lib.require_rows(knots, "knots", torch.int64, dev, nt)
    for name, arr in (("u0", u0), ("slope", slope)):
        cuda_lib.require_rows(arr, name, torch.float32, dev, nt, mk)
    cuda_lib.require_rows(ranks, "ranks", torch.int32, dev, nt, mk)
    cuda_lib.require_rows(radix, "radix", torch.int32, dev, nt)
    cuda_lib.require(m_valid, "m_valid", torch.int32, dev, nt)
    cuda_lib.require(eps, "eps", torch.int32, dev, nt)
    if n == 0 or n >= 2**31 or mk == 0 or rn < 2:
        raise ValueError(f"need 1 .. 2**31-1 keys a table, >= 1 knot and >= 2 radix entries, "
                         f"got n={n}, knots={mk}, radix={rn}")
    if dev.type == "cpu":
        return batched_rs_search_plain(u, queries, prefix, tables, knots, u0, slope, ranks, radix,
                                       m_valid, eps, ksteps=ksteps, steps=steps)
    if dev.type != "cuda":
        raise ValueError(f"batched_rs_search runs on cuda or cpu tensors, not {dev}")
    out = torch.empty((nt, nq), dtype=torch.int32, device=dev)
    if nq == 0 or nt == 0:
        return out
    cuda_lib.launch(
        "batched_rs_search_launch", dev, u.data_ptr(), queries.data_ptr(), q_stride,
        prefix.data_ptr(), nq, nt, tables.data_ptr(), n, knots.data_ptr(), u0.data_ptr(),
        slope.data_ptr(), ranks.data_ptr(), mk, radix.data_ptr(), rn, m_valid.data_ptr(),
        eps.data_ptr(), ksteps, steps, out.data_ptr(),
    )
    global BATCHED_LAUNCHES
    BATCHED_LAUNCHES += 1
    return out
