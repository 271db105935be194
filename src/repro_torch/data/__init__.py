"""Seeded synthetic datasets and query sampling (counterpart of ``repro.data``)."""

from . import distributions, tables
from .distributions import DATASETS, generate
from .tables import TIERS, make_queries

__all__ = ["distributions", "tables", "DATASETS", "TIERS", "generate", "make_queries"]
