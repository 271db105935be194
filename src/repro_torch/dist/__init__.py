"""Tier substrate (counterpart of ``repro.dist``): leaf-wise stacking of
same-spec per-table indexes.  The routed, collective tier is a later
slice."""

from . import sharded_index
from .sharded_index import stack_indexes

__all__ = ["sharded_index", "stack_indexes"]
