"""repro_torch.index — build learned static indexes and answer predecessor
queries (counterpart of ``repro.index``).

    from repro_torch import index as ix
    idx = ix.build(ix.PGMSpec(eps=64), table)          # leaves on the card
    ranks = idx.lookup(table, queries, backend="kernel")   # or "xla", "bbs", "ref"
    lo, hi = idx.intervals(table, queries)             # the predicted windows

    g = ix.build("GAPPED", table)                      # the updatable kind
    g2, report = g.insert_batch(new_keys)              # absorb, overflow to the delta
    ranks = g2.lookup(table, queries, backend="xla")   # "xla", "bbs" or "ref";
                                                       # GAPPED ignores the table

``device=None`` means the card and raises without one; tests pass
``device="cpu"``, where the kernels' plain twins answer.
"""

from . import impls, mutation, updatable  # noqa: F401  — register the kinds, GAPPED last
from .index import (BACKENDS, INTERVAL_BACKENDS, KEY_LEAVES, Index, build, lookup_impl,
                    resolve_device)
from .mutation import InsertReport, NeedsRebuild, updatable_kinds
from .registry import entry, kinds, spec_for
from .specs import (
    AtomicSpec,
    BTreeSpec,
    GappedSpec,
    IndexSpec,
    KOSpec,
    PGMBicriteriaSpec,
    PGMSpec,
    RMISpec,
    RSSpec,
    SYRMISpec,
)

__all__ = [
    "BACKENDS",
    "INTERVAL_BACKENDS",
    "KEY_LEAVES",
    "Index",
    "build",
    "lookup_impl",
    "resolve_device",
    "entry",
    "kinds",
    "spec_for",
    "AtomicSpec",
    "BTreeSpec",
    "GappedSpec",
    "IndexSpec",
    "InsertReport",
    "NeedsRebuild",
    "KOSpec",
    "PGMBicriteriaSpec",
    "PGMSpec",
    "RMISpec",
    "RSSpec",
    "SYRMISpec",
    "updatable_kinds",
]
