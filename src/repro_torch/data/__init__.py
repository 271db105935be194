"""Seeded synthetic datasets, table tiers and query sampling, the LM
token pipeline and the graph sampler (counterpart of ``repro.data``)."""

from . import distributions, pipeline, sampler, tables
from .distributions import DATASETS, generate
from .pipeline import PackedCorpus, TokenBatcher, synth_corpus
from .sampler import CSRGraph, sample_neighbors, synth_powerlaw_graph
from .tables import (
    TIERS,
    BenchTable,
    kl_divergence,
    ks_statistic,
    make_bench_tables,
    make_queries,
    subsample_preserving_cdf,
)

__all__ = ["distributions", "pipeline", "sampler", "tables", "DATASETS", "TIERS", "BenchTable",
           "CSRGraph", "PackedCorpus", "TokenBatcher", "generate", "kl_divergence",
           "ks_statistic", "make_bench_tables", "make_queries", "sample_neighbors",
           "subsample_preserving_cdf", "synth_corpus", "synth_powerlaw_graph"]
