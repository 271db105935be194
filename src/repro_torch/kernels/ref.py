"""Plain oracle for the search kernels (counterpart of ``repro.kernels.ref``),
and the row loop the batched twins share."""

from __future__ import annotations

import torch


def predecessor_ref(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Predecessor rank of each query over encoded (sign-flipped int64)
    keys: ``searchsorted(right=True) - 1`` as int64."""
    return torch.searchsorted(table, queries, right=True) - 1


def rows_with_probes(tables: torch.Tensor, probes, row_fn):
    """Run a single-table twin once per table row (``row_fn(t, probes)``)
    and stack the ranks.  ``probes``, when a list, receives every table
    index gathered, as an index into ``tables.reshape(-1)``."""
    n = tables.shape[1]
    out = []
    for t in range(tables.shape[0]):
        mine = [] if probes is not None else None
        out.append(row_fn(t, mine))
        if probes is not None:
            probes.extend(p + t * n for p in mine)
    return torch.stack(out) if out else torch.empty((0, 0), dtype=torch.int32)
