"""Fused RMI predict + ε-bounded search — the kernel backend of the RMI and
SY-RMI kinds (CUDA source: ``csrc/rmi_search.cu``).

Replaces ``repro/kernels/rmi_search.py:fused_rmi_search_pallas`` and
``batched_rmi_search_pallas``.  Per query: ``u``, the f32 CDF coordinate
of the encoded query, is computed in the kernel from the index's f64
``kmin`` and ``inv_span`` exactly as :func:`repro_torch.core.keys.unit_f32`
computes it (the TPU kernel took ``u`` from outside: it has no f64); the
f32 cubic root in Horner form on ``u`` picks a leaf, the leaf's f32 line
predicts the rank, the centre is clamped into the leaf's rank fences and
widened by the leaf's ε, and a Khuong–Morin search over that window
returns the predecessor rank, each query stopping once its window is one
key wide (``steps`` is only the cap).  The arithmetic is the
reference's, operation for operation, on the ``k_*`` re-encoded leaves —
no fused multiply-add (the re-encoded ε budgets one, see
:mod:`repro_torch.kernels.ops`), every float clamped to ±1e9 before its
int32 cast — with one exception, the leaf product (:func:`_rmi_leaf`).
Keys are sign-flipped int64, compared with one signed 64-bit compare.

Bound on the H100: bytes — the leaf gathers hit a few KB of parameters,
but each search trip is a dependent gather into a table that, at 2^24
keys, lives in HBM.  The design cuts the trips to each query's own
window and the lookup's separate f64 ``u`` pass; one thread a query,
table and leaves in global memory.
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


def _rmi_leaf(p_root, *, b: int, n: int):
    """Leaf of a clamped f32 root prediction: ``floor(f64(p_root) * (b/n))``
    in [0, b-1], the product in f64 exactly as the re-encoder assigns
    leaves (:func:`repro_torch.kernels.ops.rmi_kernel_arrays`).

    The reference kernel multiplies in f32 by ``f32(b/n)``; near a leaf
    boundary that can round one leaf past the re-encoder's f64 product,
    and that leaf's fences exclude the true rank.  The card has f64, so
    the kernel and this twin take the re-encoder's product."""
    leaf = torch.floor(p_root.to(torch.float64) * (b / n))
    return torch.clamp(leaf, 0, b - 1).to(torch.int32)


def _rmi_window_body(u, c, slope_a, icept_a, eps_a, rlo_a, rhi_a, *, b: int, n: int):
    """The kernel's guaranteed search window ``[lo, hi]`` (int32) of each
    query's ``u``: root -> leaf -> leaf line -> fences and ε."""
    # --- root -> leaf (clamp before the int32 cast) ---
    p_root = ((c[3] * u + c[2]) * u + c[1]) * u + c[0]
    p_root = torch.clamp(p_root, -1.0e9, 1.0e9)
    leaf = _rmi_leaf(p_root, b=b, n=n)

    # --- leaf linear predict + guaranteed window ---
    slope = slope_a[leaf]
    icept = icept_a[leaf]
    eps = eps_a[leaf]
    rlo = rlo_a[leaf]
    rhi = rhi_a[leaf]
    p = torch.clamp(slope * u + icept, -1.0e9, 1.0e9)
    # clamp the predicted centre into the leaf fences before widening
    p_lo = torch.minimum(torch.maximum(torch.floor(p).to(torch.int32), rlo), rhi)
    p_hi = torch.minimum(torch.maximum(torch.ceil(p).to(torch.int32), rlo), rhi)
    lo = torch.minimum(torch.maximum(p_lo - eps, rlo), rhi)
    hi = torch.minimum(torch.maximum(p_hi + eps, rlo), rhi)
    return lo, hi


def _rmi_body(u, q, t, c, slope_a, icept_a, eps_a, rlo_a, rhi_a, *, b: int, n: int, steps: int,
              probes=None):
    """The kernel's arithmetic on tensors (int32 predecessor ranks), from
    the f32 ``u`` on.  ``probes``, when a list, receives every table index
    gathered: each trip's probes of the queries whose window is still
    wider than one key (the kernel's early exit), then the last probe of
    every query."""
    lo, hi = _rmi_window_body(u, c, slope_a, icept_a, eps_a, rlo_a, rhi_a, b=b, n=n)

    # --- bounded search: a query's trips end once its window is one key ---
    base = lo
    length = hi - lo + 1
    for _ in range(steps):
        half = length >> 1
        mid = base + half
        active = length > 1
        go_right = (t[mid] <= q) & active
        base = torch.where(go_right, mid, base)
        length = length - torch.where(active, half, 0)
        if probes is not None:
            probes.append(mid[active])
    if probes is not None:
        probes.append(base)
    le = (t[base] <= q).to(torch.int32)
    return base + le - 1


def rmi_search_plain(queries, table, kmin, inv_span, root, slope, icept, eps, rlo, rhi, *,
                     steps: int, probes=None):
    """The twin on the wrapper's operands, on any device: ``u`` by
    :func:`unit_f32` (the kernel's first step), then :func:`_rmi_body`."""
    u = unit_f32(queries, kmin, inv_span)
    return _rmi_body(u, queries, table, root, slope, icept, eps, rlo, rhi,
                     b=slope.numel(), n=table.numel(), steps=steps, probes=probes)


def rmi_search(queries, table, kmin, inv_span, root, slope, icept, eps, rlo, rhi, *, steps: int):
    """Predecessor rank (int32) of each encoded query through the fused
    RMI kernel.  ``kmin`` and ``inv_span`` are the index's f64 CDF
    normalisation (one element each); the leaf operands are its ``k_*``
    leaves; ``steps`` caps the search trips.  CPU tensors take the plain
    twin; CUDA tensors launch the kernel."""
    dev = queries.device
    nq, n, b = queries.numel(), table.numel(), slope.numel()
    cuda_lib.require(queries, "queries", torch.int64, dev)
    cuda_lib.require(kmin, "kmin", torch.float64, dev, 1)
    cuda_lib.require(inv_span, "inv_span", torch.float64, dev, 1)
    cuda_lib.require(table, "table", torch.int64, dev)
    cuda_lib.require(root, "root", torch.float32, dev, 4)
    cuda_lib.require(slope, "slope", torch.float32, dev)
    cuda_lib.require(icept, "icept", torch.float32, dev, b)
    for name, arr in (("eps", eps), ("rlo", rlo), ("rhi", rhi)):
        cuda_lib.require(arr, name, torch.int32, dev, b)
    if n == 0 or n >= 2**31 or b == 0:
        raise ValueError(f"need 1 .. 2**31-1 table keys and >= 1 leaf, got n={n}, b={b}")
    if dev.type == "cpu":
        return rmi_search_plain(queries, table, kmin, inv_span, root, slope, icept, eps, rlo, rhi,
                                steps=steps)
    if dev.type != "cuda":
        raise ValueError(f"rmi_search runs on cuda or cpu tensors, not {dev}")
    out = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    if nq == 0:
        return out
    cuda_lib.launch(
        "rmi_search_launch", dev, queries.data_ptr(), nq, kmin.data_ptr(), inv_span.data_ptr(),
        table.data_ptr(), root.data_ptr(), slope.data_ptr(), icept.data_ptr(), eps.data_ptr(),
        rlo.data_ptr(), rhi.data_ptr(), b, b / n, steps, out.data_ptr(),
    )
    global LAUNCHES
    LAUNCHES += 1
    return out


def _batched_rmi_body(u, q, tables, c, slope_a, icept_a, eps_a, rlo_a, rhi_a, *, b: int, n: int,
                      steps: int, probes=None):
    """The batched kernel's arithmetic: :func:`_rmi_body` on each table row
    with that row of ``u`` and of every stacked leaf."""
    return rows_with_probes(
        tables, probes,
        lambda t, p: _rmi_body(u[t], q[t], tables[t], c[t], slope_a[t], icept_a[t], eps_a[t],
                               rlo_a[t], rhi_a[t], b=b, n=n, steps=steps, probes=p),
    )


def batched_rmi_search_plain(queries, tables, kmin, inv_span, root, slope, icept, eps, rlo, rhi, *,
                             steps: int, probes=None):
    """The batched twin on the wrapper's operands, on any device: ``u`` of
    row ``t`` from table ``t``'s ``kmin`` and ``inv_span``, then
    :func:`_batched_rmi_body`."""
    u = unit_f32(queries, kmin[:, None], inv_span[:, None])
    return _batched_rmi_body(u, queries, tables, root, slope, icept, eps, rlo, rhi,
                             b=slope.shape[1], n=tables.shape[1], steps=steps, probes=probes)


def batched_rmi_search(queries, tables, kmin, inv_span, root, slope, icept, eps, rlo, rhi, *,
                       steps: int):
    """Predecessor ranks ``(n_tables, B)`` (int32) through the batched
    fused RMI kernel, one launch for every table: row ``t`` of ``queries``
    against row ``t`` of the ``(n_tables, n)`` ``tables``, element ``t`` of
    the ``(n_tables,)`` f64 ``kmin`` and ``inv_span``, and row ``t`` of the
    stacked ``k_*`` leaves.  ``queries`` may be one ``(B,)`` batch
    ``expand``-ed to every table; ``steps`` caps the widest table's window.
    CPU tensors take the plain twin; CUDA tensors launch the kernel."""
    dev = queries.device
    nt = tables.shape[0] if tables.dim() == 2 else -1
    cuda_lib.require_rows(tables, "tables", torch.int64, dev, nt)
    q_stride = cuda_lib.query_rows(queries, nt, dev)
    n, nq, b = tables.shape[1], queries.shape[1], slope.shape[-1]
    cuda_lib.require(kmin, "kmin", torch.float64, dev, nt)
    cuda_lib.require(inv_span, "inv_span", torch.float64, dev, nt)
    cuda_lib.require_rows(root, "root", torch.float32, dev, nt, 4)
    for name, arr in (("slope", slope), ("icept", icept)):
        cuda_lib.require_rows(arr, name, torch.float32, dev, nt, b)
    for name, arr in (("eps", eps), ("rlo", rlo), ("rhi", rhi)):
        cuda_lib.require_rows(arr, name, torch.int32, dev, nt, b)
    if n == 0 or n >= 2**31 or b == 0:
        raise ValueError(f"need 1 .. 2**31-1 keys a table and >= 1 leaf, got n={n}, b={b}")
    if dev.type == "cpu":
        return batched_rmi_search_plain(queries, tables, kmin, inv_span, root, slope, icept, eps,
                                        rlo, rhi, steps=steps)
    if dev.type != "cuda":
        raise ValueError(f"batched_rmi_search runs on cuda or cpu tensors, not {dev}")
    out = torch.empty((nt, nq), dtype=torch.int32, device=dev)
    if nq == 0 or nt == 0:
        return out
    cuda_lib.launch(
        "batched_rmi_search_launch", dev, queries.data_ptr(), q_stride, nq, nt, kmin.data_ptr(),
        inv_span.data_ptr(), tables.data_ptr(), n, root.data_ptr(), slope.data_ptr(),
        icept.data_ptr(), eps.data_ptr(), rlo.data_ptr(), rhi.data_ptr(), b, b / n, steps,
        out.data_ptr(),
    )
    global BATCHED_LAUNCHES
    BATCHED_LAUNCHES += 1
    return out
