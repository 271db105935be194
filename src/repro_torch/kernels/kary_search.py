"""Model-free predecessor search over the whole table — the kernel backend
of the L, Q, C, KO and BTREE kinds, and the batched backend of every kind
without a fused batched kernel (CUDA source: ``csrc/kary_search.cu``).

Replaces ``repro/kernels/kary_search.py:kary_search_pallas`` and
``batched_kary_search_pallas``, whose lane-wide k = 128 fence compare
suits a TPU vector unit.  On the H100 one thread answers one query with a
branch-free binary search (k = 2): the ranks do not depend on k, and a
thread's ``ceil(log2 n)`` dependent loads touch fewer 32-byte sectors
than a warp's 32-fence step.

Bound on the H100: bytes — every probe is a dependent gather into a table
that, at 2^24 keys, lives in HBM.  This first design does nothing about
that (no shared-memory top levels, no prefetch); the plain form comes
first, speed is later work.
"""

from __future__ import annotations

import torch

from repro_torch.core.cdf import ceil_log2

from . import cuda_lib
from .ref import rows_with_probes

#: kernel launches (CUDA path only); reset by callers that count them
LAUNCHES = 0
#: launches of the batched kernel (CUDA path only)
BATCHED_LAUNCHES = 0


def _kary_body(q, t, *, n: int, steps: int, probes=None):
    """The kernel's arithmetic on tensors: ``steps`` trips of a branch-free
    binary search over ``t[0:n)``, then the predecessor rank (int32).
    ``probes``, when a list, receives every table index gathered."""
    base = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    length = torch.full(q.shape, n, dtype=torch.int32, device=q.device)
    for _ in range(steps):
        half = length >> 1
        mid = base + half
        go_right = (t[mid] <= q) & (length > 1)
        base = torch.where(go_right, mid, base)
        length = length - torch.where(length > 1, half, 0)
        if probes is not None:
            probes.append(mid)
    if probes is not None:
        probes.append(base)
    le = (t[base] <= q).to(torch.int32)
    return base + le - 1


def kary_search_plain(table: torch.Tensor, queries: torch.Tensor, *, probes=None):
    """The twin on the wrapper's operands, on any device."""
    n = table.numel()
    return _kary_body(queries, table, n=n, steps=ceil_log2(n), probes=probes)


def kary_search(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Predecessor rank (int32) of each encoded query over the encoded
    sorted ``table``.  CPU tensors take the plain twin; CUDA tensors
    launch the kernel."""
    n = table.numel()
    cuda_lib.require(table, "table", torch.int64, queries.device)
    cuda_lib.require(queries, "queries", torch.int64, queries.device)
    if n == 0 or n >= 2**31:
        raise ValueError(f"table must hold 1 .. 2**31-1 keys, got {n}")
    steps = ceil_log2(n)
    if queries.device.type == "cpu":
        return kary_search_plain(table, queries)
    if queries.device.type != "cuda":
        raise ValueError(f"kary_search runs on cuda or cpu tensors, not {queries.device}")
    out = torch.empty(queries.shape, dtype=torch.int32, device=queries.device)
    if queries.numel() == 0:
        return out
    cuda_lib.launch("kary_search_launch", queries.device, table.data_ptr(), n, queries.data_ptr(),
                    queries.numel(), steps, out.data_ptr())
    global LAUNCHES
    LAUNCHES += 1
    return out


def _batched_kary_body(q, tables, *, n: int, steps: int, probes=None):
    """The batched kernel's arithmetic: :func:`_kary_body` on each row of
    the ``(n_tables, n)`` tables with the same row of the queries."""
    return rows_with_probes(
        tables, probes, lambda t, p: _kary_body(q[t], tables[t], n=n, steps=steps, probes=p)
    )


def batched_kary_search_plain(tables: torch.Tensor, queries: torch.Tensor, *, probes=None):
    """The batched twin on the wrapper's operands, on any device."""
    n = tables.shape[1]
    return _batched_kary_body(queries, tables, n=n, steps=ceil_log2(n), probes=probes)


def batched_kary_search(tables: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Predecessor ranks ``(n_tables, B)`` (int32) of each row of encoded
    ``queries`` over the same row of the encoded sorted ``(n_tables, n)``
    ``tables``, in one launch.  ``queries`` may be one ``(B,)`` batch
    ``expand``-ed to every table.  CPU tensors take the plain twin; CUDA
    tensors launch the kernel."""
    dev = queries.device
    nt = tables.shape[0] if tables.dim() == 2 else -1
    cuda_lib.require_rows(tables, "tables", torch.int64, dev, nt)
    q_stride = cuda_lib.query_rows(queries, nt, dev)
    n = tables.shape[1]
    if n == 0 or n >= 2**31:
        raise ValueError(f"tables must hold 1 .. 2**31-1 keys a row, got {n}")
    if dev.type == "cpu":
        return batched_kary_search_plain(tables, queries)
    if dev.type != "cuda":
        raise ValueError(f"batched_kary_search runs on cuda or cpu tensors, not {dev}")
    nq = queries.shape[1]
    out = torch.empty((nt, nq), dtype=torch.int32, device=dev)
    if nq == 0 or nt == 0:
        return out
    cuda_lib.launch("batched_kary_search_launch", dev, tables.data_ptr(), nt, n,
                    queries.data_ptr(), q_stride, nq, ceil_log2(n), out.data_ptr())
    global BATCHED_LAUNCHES
    BATCHED_LAUNCHES += 1
    return out
