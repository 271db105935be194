"""Hashable build specs, one frozen dataclass per index kind (counterpart
of ``repro.index.specs``, for the kinds this package builds)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class IndexSpec:
    """Base class for all index build specs (hashable, immutable)."""

    kind = "?"  # overridden per subclass (class attribute, not a field)


@dataclass(frozen=True)
class AtomicSpec(IndexSpec):
    """L / Q / C: one degree-1/2/3 polynomial over the whole CDF."""

    degree: int = 1

    @property
    def kind(self) -> str:  # type: ignore[override]
        return {1: "L", 2: "Q", 3: "C"}[self.degree]


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
