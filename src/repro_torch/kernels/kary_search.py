"""Model-free predecessor search over the whole table — the kernel backend
of the L, Q, C and KO kinds (CUDA source: ``csrc/kary_search.cu``).

Replaces ``repro/kernels/kary_search.py:kary_search_pallas``, whose
lane-wide k = 128 fence compare suits a TPU vector unit.  On the H100 one
thread answers one query with a branch-free binary search (k = 2): the
ranks do not depend on k, and a thread's ``ceil(log2 n)`` dependent loads
touch fewer 32-byte sectors than a warp's 32-fence step.

Bound on the H100: bytes — every probe is a dependent gather into a table
that, at 2^24 keys, lives in HBM.  This first design does nothing about
that (no shared-memory top levels, no prefetch); the plain form comes
first, speed is later work.
"""

from __future__ import annotations

import torch

from repro_torch.core.cdf import ceil_log2

from . import cuda_lib

#: kernel launches (CUDA path only); reset by callers that count them
LAUNCHES = 0


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
    lib = cuda_lib.library()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.kary_search_launch(
            table.data_ptr(), n, queries.data_ptr(), queries.numel(), steps, out.data_ptr(), stream
        )
    cuda_lib.check(rc, "kary_search_kernel")
    global LAUNCHES
    LAUNCHES += 1
    return out
