"""The mutation surface of updatable index kinds (counterpart of
``repro.index.mutation``).

One lifecycle, behind two :class:`~repro_torch.index.Index` methods::

    absorb -> overflow -> compact -> retune

* ``Index.insert_batch(keys)`` — keys are routed to their model-guided
  leaf; leaves with room **absorb** them (gapped arrays), full leaves
  **overflow** them into the sorted delta buffer, and the returned
  :class:`InsertReport` sets ``needs_compaction`` once the delta fills
  past :data:`COMPACT_FILL`.
* ``Index.compact()`` — folds the delta into rebalanced gapped leaves
  (no model refit; only the root model's ε is re-measured against the
  new fences).
* **retune** — rebuilding with a larger spec — is the caller's answer to
  :class:`NeedsRebuild`.

Static kinds raise ``TypeError`` from both methods: updatability is a
per-kind capability registered with :func:`register_mutator`, as query
implementations are registered per kind.  Both methods are pure: the
input index is left as it was.  Every report is counted into the
``mutation_*`` metrics of :mod:`repro_torch.obs` (labeled by kind), and
every completed ``compact`` into ``mutation_compactions``: host floats,
no launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

#: delta fill fraction past which ``InsertReport.needs_compaction`` is
#: set — the cue to schedule a compaction between batches
COMPACT_FILL = 0.5


class NeedsRebuild(RuntimeError):
    """Raised when a mutation cannot fit the index's fixed capacity
    (leaves + delta exhausted): the cue to rebuild with a larger spec."""


@dataclass(frozen=True)
class InsertReport:
    """Host-side summary of one ``insert_batch`` call."""

    requested: int  #: keys passed in
    absorbed: int  #: merged into leaf gaps
    overflowed: int  #: diverted to the delta buffer
    duplicates: int  #: already present (within the batch or in the index)
    delta_count: int  #: delta occupancy after the call
    delta_cap: int  #: delta capacity
    compacted: bool  #: True if an automatic compaction ran mid-call

    @property
    def delta_fill(self) -> float:
        return self.delta_count / max(self.delta_cap, 1)

    @property
    def needs_compaction(self) -> bool:
        return self.delta_fill >= COMPACT_FILL


@dataclass(frozen=True)
class Mutator:
    """Per-kind mutation implementation:
    ``insert_batch(index, keys, auto_compact=...) -> (Index, InsertReport)``
    and ``compact(index) -> Index``; both may raise :class:`NeedsRebuild`."""

    insert_batch: Callable
    compact: Callable


MUTATORS: Dict[str, Mutator] = {}


def register_mutator(kind: str, mutator: Mutator) -> None:
    if kind in MUTATORS:
        raise ValueError(f"mutator for kind {kind!r} registered twice")
    MUTATORS[kind] = mutator


def updatable_kinds() -> tuple:
    """Kinds that support ``insert_batch``/``compact``."""
    return tuple(MUTATORS)


def _mutator(index) -> Mutator:
    m = MUTATORS.get(index.kind)
    if m is None:
        raise TypeError(
            f"index kind {index.kind!r} is static — only {updatable_kinds()} "
            "support insert_batch/compact (rebuild instead, or route ingest "
            "through an updatable kind such as GAPPED)"
        )
    return m


def _record_report(kind: str, report: InsertReport) -> None:
    """Aggregate an InsertReport into the ``mutation_*`` registry counters
    (labeled by kind).  Host-side only: no launch."""
    from repro_torch import obs

    obs.metric("mutation_requested").inc(report.requested, kind=kind)
    obs.metric("mutation_absorbed").inc(report.absorbed, kind=kind)
    obs.metric("mutation_overflowed").inc(report.overflowed, kind=kind)
    obs.metric("mutation_duplicates").inc(report.duplicates, kind=kind)
    if report.compacted:
        obs.metric("mutation_compactions").inc(kind=kind)


def insert_batch(index, keys, *, auto_compact: bool = True):
    """Dispatch ``insert_batch`` to the kind's registered mutator and count
    its report."""
    new, report = _mutator(index).insert_batch(index, keys, auto_compact=auto_compact)
    _record_report(index.kind, report)
    return new, report


def compact(index):
    """Dispatch ``compact`` to the kind's registered mutator and count it."""
    out = _mutator(index).compact(index)
    from repro_torch import obs

    obs.metric("mutation_compactions").inc(kind=index.kind)
    return out
