"""Batched builds (counterpart of ``repro.tune``): ``build_many`` (one
spec, many tables) and the stacked :class:`BatchedIndexes`.  The tuner,
mining and rebuild policies are later slices."""

from . import batched
from .batched import BATCH_BACKENDS, FITS, BatchedIndexes, build_many

__all__ = ["batched", "BATCH_BACKENDS", "FITS", "BatchedIndexes", "build_many"]
