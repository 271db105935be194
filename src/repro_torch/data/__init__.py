"""Seeded synthetic datasets, table tiers and query sampling (counterpart
of ``repro.data``)."""

from . import distributions, tables
from .distributions import DATASETS, generate
from .tables import (
    TIERS,
    BenchTable,
    kl_divergence,
    ks_statistic,
    make_bench_tables,
    make_queries,
    subsample_preserving_cdf,
)

__all__ = ["distributions", "tables", "DATASETS", "TIERS", "BenchTable", "generate",
           "kl_divergence", "ks_statistic", "make_bench_tables", "make_queries",
           "subsample_preserving_cdf"]
