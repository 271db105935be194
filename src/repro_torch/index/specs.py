"""Hashable build specs, one frozen dataclass per index kind (counterpart
of ``repro.index.specs``).  Each spec
class's ``default_grid(n_keys)`` is the reference's: the handful of
configurations that span the kind's time-space curve."""

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

    def params(self) -> dict:
        """The spec's fields (what ``registry.spec_for`` rebuilds it from)."""
        return dataclasses.asdict(self)

    @classmethod
    def default_grid(cls, n_keys: int) -> tuple:
        """The kind's default candidate specs for a table of ``n_keys``:
        the sweep grid of the Pareto tuner (:mod:`repro_torch.tune.pareto`),
        so a registered kind enrols itself.  The base grid is the kind's
        default configuration."""
        return (cls(),)


@dataclass(frozen=True)
class AtomicSpec(IndexSpec):
    """L / Q / C: one degree-1/2/3 polynomial over the whole CDF."""

    degree: int = 1

    @property
    def kind(self) -> str:  # type: ignore[override]
        return {1: "L", 2: "Q", 3: "C"}[self.degree]

    def display_name(self) -> str:
        return self.kind

    @classmethod
    def default_grid(cls, n_keys: int) -> tuple:
        return tuple(cls(degree=d) for d in (1, 2, 3))


@dataclass(frozen=True)
class KOSpec(IndexSpec):
    """KO: k equal-rank segments, best atomic model each."""

    k: int = 15
    kind = "KO"

    @classmethod
    def default_grid(cls, n_keys: int) -> tuple:
        return tuple(cls(k=k) for k in (7, 15, 31) if k <= max(n_keys // 2, 2))


@dataclass(frozen=True)
class RMISpec(IndexSpec):
    """Two-level RMI: monotone root + b linear leaves."""

    b: int = 1024
    root_type: str = "linear"
    kind = "RMI"

    @classmethod
    def default_grid(cls, n_keys: int) -> tuple:
        bs = [b for b in (64, 1024, 16384, 262144) if b <= max(n_keys // 2, 2)] or [2]
        return tuple(cls(b=b) for b in bs)


@dataclass(frozen=True)
class SYRMISpec(IndexSpec):
    """Synoptic RMI: winner architecture at a %-of-table space budget."""

    space_pct: float = 2.0
    ub: float = 0.05
    winner_root: str = "linear"
    kind = "SY-RMI"

    @classmethod
    def default_grid(cls, n_keys: int) -> tuple:
        # the paper's small-model-space sweep: budgets as a % of table bytes
        return tuple(cls(space_pct=p) for p in (0.05, 0.7, 2.0, 10.0))


@dataclass(frozen=True)
class PGMSpec(IndexSpec):
    """PGM: ε-controlled recursive piecewise-linear model."""

    eps: int = 64
    kind = "PGM"

    @classmethod
    def default_grid(cls, n_keys: int) -> tuple:
        return tuple(cls(eps=e) for e in (16, 64, 256))


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

    @classmethod
    def default_grid(cls, n_keys: int) -> tuple:
        return tuple(cls(space_pct=p) for p in (0.05, 0.7, 2.0))


@dataclass(frozen=True)
class RSSpec(IndexSpec):
    """RadixSpline: greedy ε-spline + radix table over the top r bits."""

    eps: int = 32
    r_bits: int = 12
    kind = "RS"

    @classmethod
    def default_grid(cls, n_keys: int) -> tuple:
        r = 8 if n_keys < 1 << 16 else 12
        return tuple(cls(eps=e, r_bits=r) for e in (16, 64))


@dataclass(frozen=True)
class BTreeSpec(IndexSpec):
    """Array-packed static B+-tree baseline."""

    fanout: int = 16
    kind = "BTREE"

    @classmethod
    def default_grid(cls, n_keys: int) -> tuple:
        return tuple(cls(fanout=f) for f in (8, 16))


@dataclass(frozen=True)
class GappedSpec(IndexSpec):
    """ALEX-style updatable index: gapped leaves + sorted delta buffer.

    ``leaf_cap`` keys of capacity per leaf, filled to ``fill`` at build /
    compaction time (the rest are model-guided insertion gaps);
    ``delta_cap`` bounds the sorted overflow buffer merged at lookup.
    """

    leaf_cap: int = 256
    fill: float = 0.75
    delta_cap: int = 1024
    kind = "GAPPED"

    @classmethod
    def default_grid(cls, n_keys: int) -> tuple:
        caps = [c for c in (64, 256, 1024) if c <= max(n_keys, 64)]
        return tuple(cls(leaf_cap=c) for c in caps) or (cls(leaf_cap=64),)
