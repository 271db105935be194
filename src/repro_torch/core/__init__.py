"""Model builds, search procedures and key utilities (counterpart of
``repro.core``).

The fits are host numpy, copied operation for operation from the
reference, so a model built here has the same leaves bit for bit.  The
search procedures (:mod:`~repro_torch.core.search`) and each model's
query side (``intervals``, ``predecessor``) run on encoded key tensors.
"""

from . import atomic, btree, cdf, kbfs, keys, pgm, radix_spline, rmi, search, sy_rmi
from .cdf import as_table, ceil_log2, model_reduction_factor, reduction_factor, true_ranks
from .search import NO_PRED

__all__ = [
    "atomic",
    "btree",
    "cdf",
    "kbfs",
    "keys",
    "pgm",
    "radix_spline",
    "rmi",
    "search",
    "sy_rmi",
    "as_table",
    "ceil_log2",
    "model_reduction_factor",
    "reduction_factor",
    "true_ranks",
    "NO_PRED",
]
