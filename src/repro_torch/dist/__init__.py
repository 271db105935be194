"""Tier substrate (counterpart of ``repro.dist``): leaf-wise stacking of
same-spec per-table indexes, and the sharded tier answered in one
process (``ShardedIndex``, ``sharded_lookup``).  The collective modes on
``torch.distributed`` are a later slice."""

from . import sharded_index
from .sharded_index import DROPPED, NO_PRED, ShardedIndex, sharded_lookup, stack_indexes

__all__ = ["sharded_index", "DROPPED", "NO_PRED", "ShardedIndex", "sharded_lookup",
           "stack_indexes"]
