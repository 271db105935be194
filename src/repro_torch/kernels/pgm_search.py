"""Fused PGM descent — the kernel backend of the PGM and PGM_M kinds
(CUDA source: ``csrc/pgm_search.cu``).

Replaces ``repro/kernels/pgm_search.py:fused_pgm_search_pallas`` and
``batched_pgm_search_pallas``.  Per query: ``u``, the f32 CDF coordinate
of the encoded query, is computed in the kernel from the index's f64
``pk_kmin`` and ``pk_inv_span`` exactly as
:func:`repro_torch.core.keys.unit_f32` computes it (the TPU kernel took
``u`` from outside: it has no f64).  Then, top-down over ``levels``: the
current segment's f32 anchor ``u0``, slope and rank fences ``r0``/``r1``
predict ``r0 + slope * max(u - u0, 0)`` in f32; the centre is clamped
into ``[r0 - 1, r1 - 1]`` and widened by ``ε + 1``; an upper-bound search
of that window over the next level's segment keys — or over the table at
the last level, which gives the predecessor rank — stops once the window
is one key wide, ``steps`` only the cap.  The arithmetic is the
reference's on the ``pk_*`` re-encoded leaves: no fused multiply-add,
every float clamped to ±1e9 before its int32 cast.  The level
directories (``rank0``, ``off``, ``off_r``, ``sizes``) are read as the
index holds them, int64, and narrowed to int32 in the kernel.  Keys are
sign-flipped int64, compared with one signed 64-bit compare; ``levels``
and the trip cap are run-time values.

Bound on the H100: the dependent loads — the last level's search gathers
from a table that, at 2^24 keys, lives in HBM.  Each query makes its own
window's trips at every level, and the lookup no longer pays for a
separate ``u`` pass or int32 copies of the directories.
"""

from __future__ import annotations

import torch

from repro_torch.core.keys import unit_f32

from . import cuda_lib
from .ref import rows_with_probes

#: kernel launches (CUDA path only); reset by callers that count them
LAUNCHES = 0
#: launches of the batched kernel (CUDA path only)
BATCHED_LAUNCHES = 0


def _bounded_ub_early(keys, q, base, length, *, steps: int, probes=None):
    """First index in [base, base+length) with key > q (``base + length``
    if none): the kernels' Khuong–Morin loop, whose trips end once a
    query's window is one key wide (``steps`` only the cap).
    ``probes`` receives each trip's probes of the queries still searching,
    then the last probe of every query."""
    for _ in range(steps):
        half = length >> 1
        mid = base + half
        active = length > 1
        base = torch.where((keys[mid] <= q) & active, mid, base)
        length = length - torch.where(active, half, 0)
        if probes is not None:
            probes.append(mid[active])
    if probes is not None:
        probes.append(base)
    return base + (keys[base] <= q).to(torch.int32)


def _pgm_level_window(u, seg, lvl: int, u0_a, slope_a, r0_a, off, off_r, eps):
    """Level ``lvl``'s guaranteed window ``[lo, hi]`` (int32) over the
    level below (the table at the last level, before the clamp to it) for
    each query's segment ``seg``; directories already int32."""
    u0 = u0_a[off[lvl] + seg]
    slope = slope_a[off[lvl] + seg]
    r0 = r0_a[off_r[lvl] + seg].to(torch.int32)
    r1 = r0_a[off_r[lvl] + seg + 1].to(torch.int32)
    pred = r0.to(torch.float32) + slope * torch.clamp(u - u0, min=0.0)
    pred = torch.clamp(pred, -1.0e9, 1.0e9)  # gap blow-ups: clamp before the cast
    b_lo = torch.clamp(r0 - 1, min=0)
    b_hi = r1 - 1
    # clamp the predicted centre into the fence range before widening
    p_lo = torch.minimum(torch.maximum(torch.floor(pred).to(torch.int32), b_lo), b_hi)
    p_hi = torch.minimum(torch.maximum(torch.ceil(pred).to(torch.int32), b_lo), b_hi)
    widen = eps[0] + 1
    lo = torch.minimum(torch.maximum(p_lo - widen, b_lo), b_hi)
    hi = torch.minimum(torch.maximum(p_hi + widen, b_lo), b_hi)
    return lo, hi


def _pgm_body(u, q, t, keys, u0_a, slope_a, r0_a, off, off_r, sizes, eps, *, levels: int, n: int,
              steps: int, probes=None):
    """The kernel's arithmetic on tensors, from the f32 ``u`` on (int32
    predecessor ranks).  ``probes``, when a list, receives every *table*
    index gathered, the trips each query takes."""
    off, off_r, sizes = (d.to(torch.int32) for d in (off, off_r, sizes))
    seg = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    for lvl in range(levels):
        lo, hi = _pgm_level_window(u, seg, lvl, u0_a, slope_a, r0_a, off, off_r, eps)
        if lvl + 1 < levels:
            base_n = off[lvl + 1]
            ub = _bounded_ub_early(keys, q, base_n + lo, hi - lo + 1, steps=steps)
            seg = torch.minimum(torch.clamp(ub - base_n - 1, min=0), sizes[lvl + 1] - 1)
        else:
            # leaf level: the window indexes the table
            lo = torch.clamp(lo, 0, n - 1)
            hi = torch.clamp(hi, 0, n - 1)
            return _bounded_ub_early(t, q, lo, hi - lo + 1, steps=steps, probes=probes) - 1
    raise ValueError("levels must be >= 1")


def pgm_search_plain(queries, table, kmin, inv_span, keys, u0, slope, rank0, off, off_r, sizes,
                     eps, *, levels: int, steps: int, probes=None):
    """The twin on the wrapper's operands, on any device: ``u`` by
    :func:`unit_f32` (the kernel's first step), then :func:`_pgm_body`."""
    u = unit_f32(queries, kmin, inv_span)
    return _pgm_body(u, queries, table, keys, u0, slope, rank0, off, off_r, sizes, eps,
                     levels=levels, n=table.numel(), steps=steps, probes=probes)


def pgm_search(queries, table, kmin, inv_span, keys, u0, slope, rank0, off, off_r, sizes, eps, *,
               levels: int, steps: int):
    """Predecessor rank (int32) of each encoded query through the fused PGM
    descent.  ``kmin`` and ``inv_span`` are the index's f64 ``pk_kmin`` and
    ``pk_inv_span`` (one element each); ``keys`` the encoded
    level-concatenated segment keys; ``u0``/``slope`` the index's ``pk_*``
    leaves; ``rank0``/``off``/``off_r``/``sizes`` its int64 level
    directories; ``eps`` a one-element int32 tensor.  CPU tensors take the
    plain twin; CUDA tensors launch the kernel."""
    dev = queries.device
    nq, n, kn = queries.numel(), table.numel(), keys.numel()
    cuda_lib.require(queries, "queries", torch.int64, dev)
    cuda_lib.require(table, "table", torch.int64, dev)
    cuda_lib.require(kmin, "kmin", torch.float64, dev, 1)
    cuda_lib.require(inv_span, "inv_span", torch.float64, dev, 1)
    cuda_lib.require(keys, "keys", torch.int64, dev)
    cuda_lib.require(u0, "u0", torch.float32, dev, kn)
    cuda_lib.require(slope, "slope", torch.float32, dev, kn)
    cuda_lib.require(rank0, "rank0", torch.int64, dev)
    cuda_lib.require(off, "off", torch.int64, dev, levels + 1)
    cuda_lib.require(off_r, "off_r", torch.int64, dev, levels + 1)
    cuda_lib.require(sizes, "sizes", torch.int64, dev, levels)
    cuda_lib.require(eps, "eps", torch.int32, dev, 1)
    if n == 0 or n >= 2**31 or levels < 1:
        raise ValueError(f"need 1 .. 2**31-1 table keys and >= 1 level, got n={n}, levels={levels}")
    if dev.type == "cpu":
        return pgm_search_plain(queries, table, kmin, inv_span, keys, u0, slope, rank0, off, off_r,
                                sizes, eps, levels=levels, steps=steps)
    if dev.type != "cuda":
        raise ValueError(f"pgm_search runs on cuda or cpu tensors, not {dev}")
    out = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    if nq == 0:
        return out
    cuda_lib.launch(
        "pgm_search_launch", dev, queries.data_ptr(), nq, kmin.data_ptr(), inv_span.data_ptr(),
        table.data_ptr(), n, keys.data_ptr(), u0.data_ptr(), slope.data_ptr(), rank0.data_ptr(),
        off.data_ptr(), off_r.data_ptr(), sizes.data_ptr(), eps.data_ptr(), levels, steps,
        out.data_ptr(),
    )
    global LAUNCHES
    LAUNCHES += 1
    return out


def _batched_pgm_body(u, q, tables, keys, u0_a, slope_a, r0_a, off, off_r, sizes, eps, *,
                      levels: int, n: int, steps: int, probes=None):
    """The batched kernel's arithmetic: :func:`_pgm_body` on each table row
    with that row of ``u`` and of every stacked leaf (``eps`` holds one ε
    a table)."""
    return rows_with_probes(
        tables, probes,
        lambda t, p: _pgm_body(u[t], q[t], tables[t], keys[t], u0_a[t], slope_a[t], r0_a[t],
                               off[t], off_r[t], sizes[t], eps[t:t + 1], levels=levels, n=n,
                               steps=steps, probes=p),
    )


def batched_pgm_search_plain(queries, tables, kmin, inv_span, keys, u0, slope, rank0, off, off_r,
                             sizes, eps, *, levels: int, steps: int, probes=None):
    """The batched twin on the wrapper's operands, on any device: ``u`` of
    row ``t`` from table ``t``'s ``kmin`` and ``inv_span``, then
    :func:`_batched_pgm_body`."""
    u = unit_f32(queries, kmin[:, None], inv_span[:, None])
    return _batched_pgm_body(u, queries, tables, keys, u0, slope, rank0, off, off_r, sizes, eps,
                             levels=levels, n=tables.shape[1], steps=steps, probes=probes)


def batched_pgm_search(queries, tables, kmin, inv_span, keys, u0, slope, rank0, off, off_r, sizes,
                       eps, *, levels: int, steps: int):
    """Predecessor ranks ``(n_tables, B)`` (int32) through the batched PGM
    descent, one launch for every table: row ``t`` of ``queries`` against
    row ``t`` of the ``(n_tables, n)`` ``tables``, element ``t`` of the
    ``(n_tables,)`` f64 ``kmin``/``inv_span`` and int32 ``eps``, and row
    ``t`` of the stacked leaves and int64 directories.  ``levels`` is
    common to the tables (lifted at stack time) and ``steps`` caps the
    widest window.  ``queries`` may be one ``(B,)`` batch ``expand``-ed to
    every table.  CPU tensors take the plain twin; CUDA tensors launch the
    kernel."""
    dev = queries.device
    nt = tables.shape[0] if tables.dim() == 2 else -1
    cuda_lib.require_rows(tables, "tables", torch.int64, dev, nt)
    q_stride = cuda_lib.query_rows(queries, nt, dev)
    n, nq, kn = tables.shape[1], queries.shape[1], keys.shape[-1]
    cuda_lib.require(kmin, "kmin", torch.float64, dev, nt)
    cuda_lib.require(inv_span, "inv_span", torch.float64, dev, nt)
    cuda_lib.require_rows(keys, "keys", torch.int64, dev, nt)
    cuda_lib.require_rows(u0, "u0", torch.float32, dev, nt, kn)
    cuda_lib.require_rows(slope, "slope", torch.float32, dev, nt, kn)
    cuda_lib.require_rows(rank0, "rank0", torch.int64, dev, nt)
    cuda_lib.require_rows(off, "off", torch.int64, dev, nt, levels + 1)
    cuda_lib.require_rows(off_r, "off_r", torch.int64, dev, nt, levels + 1)
    cuda_lib.require_rows(sizes, "sizes", torch.int64, dev, nt, levels)
    cuda_lib.require(eps, "eps", torch.int32, dev, nt)
    if n == 0 or n >= 2**31 or levels < 1:
        raise ValueError(f"need 1 .. 2**31-1 keys a table and >= 1 level, got n={n}, levels={levels}")
    if dev.type == "cpu":
        return batched_pgm_search_plain(queries, tables, kmin, inv_span, keys, u0, slope, rank0,
                                        off, off_r, sizes, eps, levels=levels, steps=steps)
    if dev.type != "cuda":
        raise ValueError(f"batched_pgm_search runs on cuda or cpu tensors, not {dev}")
    out = torch.empty((nt, nq), dtype=torch.int32, device=dev)
    if nq == 0 or nt == 0:
        return out
    cuda_lib.launch(
        "batched_pgm_search_launch", dev, queries.data_ptr(), q_stride, nq, nt, kmin.data_ptr(),
        inv_span.data_ptr(), tables.data_ptr(), n, keys.data_ptr(), u0.data_ptr(),
        slope.data_ptr(), kn, rank0.data_ptr(), rank0.shape[1], off.data_ptr(), off_r.data_ptr(),
        sizes.data_ptr(), eps.data_ptr(), levels, steps, out.data_ptr(),
    )
    global BATCHED_LAUNCHES
    BATCHED_LAUNCHES += 1
    return out
