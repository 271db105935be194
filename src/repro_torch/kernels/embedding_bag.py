"""EmbeddingBag: the weighted bag sum ``out[b] = sum_{seg[i] == b} w[i] *
table[ids[i]]`` (CUDA source: ``csrc/embedding_bag.cu``).

Replaces ``repro/kernels/embedding_bag.py:embedding_bag_pallas``
(``_bag_kernel``), which forms the sum as one-hot matrix products over
vocabulary tiles because a TPU serialises row gathers.  ``seg`` need not
be sorted; an id outside ``[0, V)`` or a bag outside ``[0, num_bags)``
adds nothing, as the one-hot products give it no row.

Bound on the H100: bytes — one table row and 12 bytes an item read, one
row a bag written.  On the card a warp takes 32 consecutive items, loads
rows 16 bytes a lane (``float4``) when ``D % 4 == 0`` and the table is
16-byte aligned (else one column a lane), keeps 8 rows in flight, and
sums each run of equal bags in registers before one atomic add a column
(sorted bags: one flush a run and a chunk edge, not one atomic a value).
The atomics add in a run-dependent order, so the kernel agrees with
:func:`_bag_body` within a tolerance.  At small shapes the wrapper's host
cost, not the device, sets the time (PERF.md).
"""

from __future__ import annotations

import torch

from . import cuda_lib

#: kernel launches (CUDA path only); reset by callers that count them
LAUNCHES = 0


def _bag_body(table, ids, seg, w, *, num_bags: int):
    """The kernel's arithmetic on tensors: ``w[i] * table[ids[i]]`` added
    into row ``seg[i]`` of a zeroed ``(num_bags, D)`` output, for the items
    whose id and bag are in range."""
    v, d = table.shape
    keep = (ids >= 0) & (ids < v) & (seg >= 0) & (seg < num_bags)
    rows = table[ids[keep].long()] * w[keep][:, None]
    out = torch.zeros((num_bags, d), dtype=torch.float32, device=table.device)
    return out.index_add_(0, seg[keep].long(), rows)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, seg: torch.Tensor, w: torch.Tensor,
                  *, num_bags: int) -> torch.Tensor:
    """``(num_bags, D)`` f32 bag sums of the f32 ``(V, D)`` ``table`` over
    int32 ``ids``/``seg`` and f32 weights ``w`` (all ``(N,)``).  CPU
    tensors take the plain twin; CUDA tensors launch the kernel."""
    dev = table.device
    cuda_lib.require_rows(table, "table", torch.float32, dev, table.shape[0] if table.dim() else -1)
    cuda_lib.require(ids, "ids", torch.int32, dev)
    n = ids.numel()
    cuda_lib.require(seg, "seg", torch.int32, dev, numel=n)
    cuda_lib.require(w, "w", torch.float32, dev, numel=n)
    if num_bags < 0 or num_bags >= 2**31 or table.shape[0] >= 2**31:
        raise ValueError(f"num_bags and V must lie in [0, 2**31), got {num_bags}, {table.shape[0]}")
    if dev.type == "cpu":
        return _bag_body(table, ids, seg, w, num_bags=num_bags)
    if dev.type != "cuda":
        raise ValueError(f"embedding_bag runs on cuda or cpu tensors, not {dev}")
    v, d = table.shape
    out = torch.empty((num_bags, d), dtype=torch.float32, device=dev)
    if num_bags == 0 or d == 0:
        return out
    cuda_lib.launch("embedding_bag_launch", dev, table.data_ptr(), v, d, ids.data_ptr(),
                    seg.data_ptr(), w.data_ptr(), n, num_bags, out.data_ptr())
    global LAUNCHES
    LAUNCHES += 1
    return out
