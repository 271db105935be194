"""Batched builds (counterpart of ``repro.tune``): ``build_many`` (one
spec, many tables; host, batched device and fast fits), ``build_grid``
(many specs, one table), the stacked :class:`BatchedIndexes`, and the
single-program shard refresh (:mod:`repro_torch.tune.device_fit`).  The
tuner, mining and rebuild policies are later slices."""

from . import batched, device_fit
from .batched import (
    BATCH_BACKENDS,
    FAST_KINDS,
    FITS,
    VMAP_KINDS,
    BatchedIndexes,
    build_grid,
    build_many,
)
from .device_fit import DEVICE_FITS, DEVICE_REFRESH_KINDS, device_refresh

__all__ = ["batched", "device_fit", "BATCH_BACKENDS", "DEVICE_FITS", "DEVICE_REFRESH_KINDS",
           "FAST_KINDS", "FITS", "VMAP_KINDS", "BatchedIndexes", "build_grid", "build_many",
           "device_refresh"]
