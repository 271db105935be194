"""Model-free predecessor search over the whole table — the kernel backend
of the L, Q, C, KO and BTREE kinds, and the batched backend of every kind
without a fused batched kernel (CUDA source: ``csrc/kary_search.cu``).

Replaces ``repro/kernels/kary_search.py:kary_search_pallas`` and
``batched_kary_search_pallas``, whose lane-wide k = 128 fence compare and
final lane sweep suit a TPU vector unit.  On the H100 each query runs the
trips of a binary search (k = 2; the ranks do not depend on k) and ends,
as the TPU kernel does, in one sweep over the last window.

Bound on the H100: the dependent loads, not the bytes — at 2^24 keys the
table lives in HBM, and one thread's ``ceil(log2 n) + 1`` gathers each
wait on the last.  The kernel serves the first ``TREE_LEVELS`` trips from
the top of the implicit search tree, staged once a block of a persistent
grid in shared memory (Eytzinger order, :func:`tree_positions`), makes
global trips until the window holds at most ``SWEEP`` keys, and then
counts the window's keys ``<= q`` with coalesced loads, a warp's windows
at a time.  The twins below do the same arithmetic on tensors.

:func:`kary_owner_route`, the sharded tier's router, is no kernel: the
reference computes it with plain array ops, and so does the port.
"""

from __future__ import annotations

import math

import torch

from . import cuda_lib
from .ref import rows_with_probes

#: the reference's lane width: the router's compare-and-sum handles this
#: many fences at once before it splits k-ary
LANES = 128

#: kernel launches (CUDA path only); reset by callers that count them
LAUNCHES = 0
#: launches of the batched kernel (CUDA path only)
BATCHED_LAUNCHES = 0
#: trips served by the shared-memory tree (``kTreeLevels`` in the source):
#: 2^10 - 1 keys, 8 KB a block
TREE_LEVELS = 10
#: the final sweep's width (``kSweep``): 256 bytes, two or three 128-byte lines
SWEEP = 32

#: queries a pass of the router's k-ary branch takes: each trip holds
#: ``(chunk, k - 1)`` fence positions and keys, 64 MiB of int64 at k = 128
ROUTE_CHUNK = 1 << 16


def kary_owner_route(boundaries: torch.Tensor, q: torch.Tensor, *, k: int = LANES) -> torch.Tensor:
    """Owner shard (int32) of each encoded query on a fence array.

    ``boundaries`` holds the encoded first key of shards ``1..S-1``
    (sorted); the owner of ``q`` is ``#{i : boundaries[i] <= q}`` in
    ``[0, S-1]``, so an exact fence key routes to the shard that starts
    with it.  Up to ``k`` fences this is one compare-and-sum; beyond that
    a k-ary search (:func:`repro_torch.core.search.bounded_kary_upper_bound`)
    in passes of :data:`ROUTE_CHUNK` queries, which bound its memory."""
    from repro_torch.core import search

    nb = int(boundaries.shape[0])
    if nb == 0:
        return torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    if nb <= k:
        return (boundaries[None, :] <= q[:, None]).sum(-1, dtype=torch.int32)
    steps = max(1, int(math.ceil(math.log(nb) / math.log(k))))
    owners = [search.bounded_kary_upper_bound(boundaries, c, torch.zeros_like(c), torch.full_like(c, nb),
                                              k=k, steps=steps).to(torch.int32)
              for c in q.reshape(-1).split(ROUTE_CHUNK)]
    return torch.cat(owners).reshape(q.shape)


def tree_levels(n: int) -> int:
    """Trips the staged tree serves over ``n`` keys: ``ceil(log2 n)``
    capped at :data:`TREE_LEVELS` (0 for one key), so the window is wider
    than one key at each of them."""
    return min(TREE_LEVELS, (n - 1).bit_length())


def tree_positions(n: int, device="cpu") -> torch.Tensor:
    """Table positions of the staged tree, in Eytzinger order: entry
    ``node`` (1 .. 2^levels - 1; entry 0 is unused, 0) is the position
    that trip ``floor(log2 node)`` probes on the path of ``node``'s bits
    below the leading one, first trip first, 1 = right.  Before trip ``j``
    the window holds ``ceil(n / 2^j)`` keys whatever the path, so a path
    fixes the position."""
    levels = tree_levels(n)
    halves, length = [], n
    for _ in range(levels):
        halves.append(length >> 1)
        length -= length >> 1
    halves = torch.tensor(halves + [0], dtype=torch.int64)
    node = torch.arange(1 << levels, dtype=torch.int64)
    depth = torch.zeros_like(node)
    for d in range(1, levels):
        depth += node >= (1 << d)
    base = torch.zeros_like(node)
    for j in range(levels - 1):  # trip j's bit, for the nodes below depth j
        below = depth > j
        bit = (node >> torch.clamp(depth - 1 - j, min=0)) & 1
        base += torch.where(below, bit * halves[j], 0)
    pos = base + halves[depth]
    pos[0] = 0
    return pos.to(device)


def search_plan(n: int) -> tuple[int, int, int]:
    """How a query's search over ``n`` keys splits, the same for every
    query: the trips down the staged tree (:func:`tree_levels`), the
    global trips, and the keys of the window the sweep reads (at most
    :data:`SWEEP`)."""
    levels, length, trips = tree_levels(n), -(-n // (1 << tree_levels(n))), 0
    while length > SWEEP:
        length, trips = length - (length >> 1), trips + 1
    return levels, trips, length


def _window_trips(t, q, base, length: int) -> list:
    """The positions a binary search over the window ``[base, base +
    length)`` reads to reach the sweep's rank: its trips and the last
    compare at ``base``.  The bound counts these, what the function
    needs, and not the sweep's other keys."""
    mids = []
    while length > 1:
        half = length >> 1
        mids.append(base + half)
        base = torch.where(t[mids[-1]] <= q, mids[-1], base)
        length -= half
    return mids + [base]


def _kary_body(q, t, *, n: int, probes=None):
    """The kernel's arithmetic on tensors: :func:`tree_levels` trips down
    the staged tree, global trips while the window holds more than
    :data:`SWEEP` keys, then the sweep's count of the window's keys
    ``<= q``; the predecessor rank (int32).  The window's length depends
    on ``n`` only, so it is a Python int.  ``probes``, when a list,
    receives the table indices a binary search reads for the same rank:
    the tree trips' positions, the global trips' and the window's
    (:func:`_window_trips`)."""
    tree = t[tree_positions(n, t.device)]
    node = torch.ones(q.shape, dtype=torch.int64, device=q.device)
    base = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    length = n
    for _ in range(tree_levels(n)):
        half = length >> 1
        right = (tree[node] <= q).to(torch.int32)
        if probes is not None:
            probes.append(base + half)
        base = base + right * half
        node = 2 * node + right
        length -= half
    while length > SWEEP:
        half = length >> 1
        mid = base + half
        base = torch.where(t[mid] <= q, mid, base)
        length -= half
        if probes is not None:
            probes.append(mid)
    if probes is not None:
        probes.extend(_window_trips(t, q, base, length))
    window = base[..., None] + torch.arange(length, dtype=torch.int32, device=q.device)
    return base + (t[window] <= q[..., None]).sum(-1, dtype=torch.int32) - 1


def kary_search_plain(table: torch.Tensor, queries: torch.Tensor, *, probes=None):
    """The twin on the wrapper's operands, on any device."""
    return _kary_body(queries, table, n=table.numel(), probes=probes)


def kary_search(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Predecessor rank (int32) of each encoded query over the encoded
    sorted ``table``.  CPU tensors take the plain twin; CUDA tensors
    launch the kernel."""
    n = table.numel()
    cuda_lib.require(table, "table", torch.int64, queries.device)
    cuda_lib.require(queries, "queries", torch.int64, queries.device)
    if n == 0 or n >= 2**31:
        raise ValueError(f"table must hold 1 .. 2**31-1 keys, got {n}")
    if queries.device.type == "cpu":
        return kary_search_plain(table, queries)
    if queries.device.type != "cuda":
        raise ValueError(f"kary_search runs on cuda or cpu tensors, not {queries.device}")
    out = torch.empty(queries.shape, dtype=torch.int32, device=queries.device)
    if queries.numel() == 0:
        return out
    cuda_lib.launch("kary_search_launch", queries.device, table.data_ptr(), n, queries.data_ptr(),
                    queries.numel(), out.data_ptr())
    global LAUNCHES
    LAUNCHES += 1
    return out


def _batched_kary_body(q, tables, *, n: int, probes=None):
    """The batched kernel's arithmetic: :func:`_kary_body` on each row of
    the ``(n_tables, n)`` tables with the same row of the queries."""
    return rows_with_probes(
        tables, probes, lambda t, p: _kary_body(q[t], tables[t], n=n, probes=p)
    )


def batched_kary_search_plain(tables: torch.Tensor, queries: torch.Tensor, *, probes=None):
    """The batched twin on the wrapper's operands, on any device."""
    return _batched_kary_body(queries, tables, n=tables.shape[1], probes=probes)


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
                    queries.data_ptr(), q_stride, nq, out.data_ptr())
    global BATCHED_LAUNCHES
    BATCHED_LAUNCHES += 1
    return out
