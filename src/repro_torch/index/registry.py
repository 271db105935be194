"""Kind registry (counterpart of ``repro.index.registry``).

Each kind registers once, in the paper's hierarchy order, binding its
spec class, its host build (``build(spec, table_np) -> (static, arrays,
info)``), and the query implementation it shares (L/Q/C share
``atomic``; PGM_M builds a PGM-shaped index and shares ``pgm``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Type

from .specs import IndexSpec


@dataclass
class KindEntry:
    kind: str
    spec_cls: Type[IndexSpec]
    build: Callable  # (spec, table_np) -> (static, arrays, info)
    query_key: str  # key into impls.QUERY_IMPLS
    spec_from_params: Callable  # (**params) -> spec


_REGISTRY: Dict[str, KindEntry] = {}


def register(kind: str, spec_cls: Type[IndexSpec], *, query_key: str, spec_from_params=None):
    """Decorator registering a build function for ``kind``."""

    def deco(build_fn):
        if kind in _REGISTRY:
            raise ValueError(f"index kind {kind!r} registered twice")
        _REGISTRY[kind] = KindEntry(
            kind=kind,
            spec_cls=spec_cls,
            build=build_fn,
            query_key=query_key,
            spec_from_params=spec_from_params or (lambda **p: spec_cls(**p)),
        )
        return build_fn

    return deco


def kinds() -> tuple:
    """Registered kinds, in the paper's hierarchy order."""
    return tuple(_REGISTRY)


def entry(kind: str) -> KindEntry:
    kind = kind.upper()
    if kind not in _REGISTRY:
        raise ValueError(f"unknown index kind {kind!r}; choose from {kinds()}")
    return _REGISTRY[kind]


def spec_for(kind: str, **params) -> IndexSpec:
    """Build the kind's spec from loose keyword parameters."""
    return entry(kind).spec_from_params(**params)
