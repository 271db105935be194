"""Hashable build specs, one frozen dataclass per index kind (counterpart
of ``repro.index.specs``, for the kinds this package builds)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class IndexSpec:
    """Base class for all index build specs (hashable, immutable)."""

    kind = "?"  # overridden per subclass (class attribute, not a field)

    def display_name(self) -> str:
        params = ",".join(f"{f.name}={getattr(self, f.name)}" for f in dataclasses.fields(self))
        return f"{self.kind}[{params}]" if params else self.kind


@dataclass(frozen=True)
class AtomicSpec(IndexSpec):
    """L / Q / C: one degree-1/2/3 polynomial over the whole CDF."""

    degree: int = 1

    @property
    def kind(self) -> str:  # type: ignore[override]
        return {1: "L", 2: "Q", 3: "C"}[self.degree]

    def display_name(self) -> str:
        return self.kind


@dataclass(frozen=True)
class KOSpec(IndexSpec):
    """KO: k equal-rank segments, best atomic model each."""

    k: int = 15
    kind = "KO"


@dataclass(frozen=True)
class RMISpec(IndexSpec):
    """Two-level RMI: monotone root + b linear leaves."""

    b: int = 1024
    root_type: str = "linear"
    kind = "RMI"


@dataclass(frozen=True)
class SYRMISpec(IndexSpec):
    """Synoptic RMI: winner architecture at a %-of-table space budget."""

    space_pct: float = 2.0
    ub: float = 0.05
    winner_root: str = "linear"
    kind = "SY-RMI"


@dataclass(frozen=True)
class PGMSpec(IndexSpec):
    """PGM: ε-controlled recursive piecewise-linear model."""

    eps: int = 64
    kind = "PGM"


@dataclass(frozen=True)
class PGMBicriteriaSpec(IndexSpec):
    """Bi-criteria PGM_M_a: smallest ε fitting a byte budget
    (``space_budget_bytes`` <= 0 means "derive from space_pct")."""

    space_budget_bytes: int = 0
    space_pct: float = 2.0
    a: float = 1.0
    kind = "PGM_M"

    def budget_for(self, n_keys: int) -> int:
        if self.space_budget_bytes > 0:
            return int(self.space_budget_bytes)
        return int(self.space_pct / 100.0 * n_keys * 8)


@dataclass(frozen=True)
class RSSpec(IndexSpec):
    """RadixSpline: greedy ε-spline + radix table over the top r bits."""

    eps: int = 32
    r_bits: int = 12
    kind = "RS"


@dataclass(frozen=True)
class BTreeSpec(IndexSpec):
    """Array-packed static B+-tree baseline."""

    fanout: int = 16
    kind = "BTREE"
