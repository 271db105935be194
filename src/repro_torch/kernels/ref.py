"""Plain oracle for the search kernels (counterpart of ``repro.kernels.ref``)."""

from __future__ import annotations

import torch


def predecessor_ref(table: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Predecessor rank of each query over encoded (sign-flipped int64)
    keys: ``searchsorted(right=True) - 1`` as int64."""
    return torch.searchsorted(table, queries, right=True) - 1
